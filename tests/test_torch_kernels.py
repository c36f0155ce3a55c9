"""The port's kernels against the JAX package's, and against their plain
versions on the card.

On the CPU each wrapper runs its plain PyTorch version, which is held
bitwise against the reference's oracle: ``np.add.at`` for the shard apply
(the reference's ``scatter_add_inplace`` with ``REPRO_PALLAS=off``; its
Pallas path no longer runs under the installed jax), the Pallas
``topk_mag`` kernel plus its f64 refine (``REPRO_PALLAS=interpret``) for the
send order, and for the VAP accumulate the Pallas ``vap_accum`` kernel in
interpret mode, its jnp ``ref`` and the sync layer's own expression
(``(d + u).astype(d.dtype)``, then ``tree_max_abs``) for a bfloat16 delta.
The LLM substrate's three: flash attention and the SSD scan against the
Pallas kernels in interpret mode and the jnp oracles, over
``tests/test_kernels.py``'s cases and tolerances; the RG-LRU recurrence
against the jnp oracle only (the Pallas kernel no longer runs under the
installed jax: ``pl.load`` is gone).

The ``cuda``-marked cases build the CUDA kernels and hold them against the
plain versions (bitwise for the parameter-server kernels and the RG-LRU
recurrence, on CPU copies; with ``tests/test_kernels.py``'s tolerances for
flash attention and the SSD scan, on the card); they skip on a host without
a CUDA device.
"""
import ctypes
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import sync as ref_sync
from repro.kernels.flash_attention import kernel as ref_fa_kernel
from repro.kernels.flash_attention import ref as ref_fa
from repro.kernels.rglru_scan import ref as ref_rg
from repro.kernels.ssd_scan import kernel as ref_ssd_kernel
from repro.kernels.ssd_scan import ref as ref_ssd
from repro.kernels.ps_apply import ops as ref_apply
from repro.kernels.topk_mag import ops as ref_topk
from repro.kernels.vap_accum import kernel as ref_vap_kernel
from repro.kernels.vap_accum import ref as ref_vap
from repro.kernels.vap_accum.ops import vap_accum_tree as ref_vap_tree
from repro_torch.kernels import _build, resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.kernels.ps_apply import ref as apply_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.topk_mag import ops as topk_ops
from repro_torch.kernels.topk_mag import ref as topk_ref
from repro_torch.kernels.vap_accum import ops as vap_ops
from repro_torch.kernels.vap_accum import ref as vap_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# ps_apply
# ---------------------------------------------------------------------------

# (R, C, N): duplicates are heavy (rows drawn from a third of the block)
_APPLY_CASES = [(16, 8, 64), (5, 1, 40), (7, 130, 50), (9, 4, 0),
                (1, 3, 20), (50, 33, 2000)]
_DTYPES = [np.float32, np.float64]


def _apply_inputs(seed, R, C, N, dtype, sentinel=False):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(R, C)).astype(dtype)
    rows = rng.integers(0, max(R // 3, 1), size=N).astype(np.int64)
    if sentinel:
        rows[rng.random(N) < 0.2] = R
    delta = rng.normal(size=(N, C)).astype(dtype)
    return dense, rows, delta


def _oracle(dense, rows, delta):
    """np.add.at over the real rows, in order; the sentinel row R is a
    no-op (the reference kernel's dummy row)."""
    keep = rows < dense.shape[0]
    out = dense.copy()
    np.add.at(out, rows[keep], delta[keep])
    return out


# the kernel's own cases, beside _APPLY_CASES: (R, C, N, kind) where kind
# "one_row" puts every entry on one row (a single run walked serially),
# "unique" gives N distinct rows in shuffled order (every thread a run's
# head), "sentinel" makes every entry the no-op row R; C = 1 with heavy
# duplicates is LDA's topic block, small; N = 1; C = 257 (not a multiple of
# a warp); a deep batch drawn from a third of the rows
_APPLY_CARD_CASES = (_APPLY_CASES
                     + [(2000, 257, 5000), (64, 16, 4096, "one_row"),
                        (50, 1, 3000), (300, 24, 300, "unique"),
                        (10, 5, 1), (12, 7, 50, "sentinel"),
                        (3000, 48, 20_000)])


def _card_apply_inputs(case, dtype):
    R, C, N, *kind = case
    dense, rows, delta = _apply_inputs(2, R, C, N, dtype, sentinel=not kind)
    rng = np.random.default_rng(3)
    if kind == ["one_row"]:
        rows[:] = R // 2
    elif kind == ["unique"]:
        rows = rng.permutation(R)[:N].astype(np.int64)
    elif kind == ["sentinel"]:
        rows[:] = R
    return dense, rows, delta


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", _APPLY_CARD_CASES, ids=str)
def test_ps_apply_plain_matches_reference(case, dtype, monkeypatch):
    """The plain version the kernel is held to, at every case the kernel
    meets on the card: the reference's np.add.at over the real rows."""
    monkeypatch.setenv("REPRO_PALLAS", "off")
    dense, rows, delta = _card_apply_inputs(case, dtype)
    keep = rows < dense.shape[0]
    want = dense.copy()
    ref_apply.scatter_add_inplace(want, rows[keep], delta[keep])
    got = torch.from_numpy(dense.copy())
    out = apply_ops.scatter_add_(got, torch.from_numpy(rows),
                                 torch.from_numpy(delta))
    assert out is got                                   # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "f64"])
def test_ps_apply_sentinel_row_is_noop(dtype):
    dense, rows, delta = _apply_inputs(1, 12, 5, 300, dtype, sentinel=True)
    assert (rows == 12).any() and (rows < 12).any()
    got = torch.from_numpy(dense.copy())
    apply_ops.scatter_add_(got, torch.from_numpy(rows),
                           torch.from_numpy(delta))
    np.testing.assert_array_equal(got.numpy(), _oracle(dense, rows, delta))
    # every row R: nothing changes at all
    got = torch.from_numpy(dense.copy())
    apply_ops.scatter_add_(got, torch.full((7,), 12, dtype=torch.int64),
                           torch.ones((7, 5), dtype=got.dtype))
    np.testing.assert_array_equal(got.numpy(), dense)


def test_ps_apply_rejects_bad_input():
    dense = torch.zeros((4, 3), dtype=torch.float64)
    ok_rows = torch.tensor([0, 4])
    with pytest.raises(IndexError):
        apply_ops.scatter_add_(dense, torch.tensor([0, 5]),
                               torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(IndexError):
        apply_ops.scatter_add_(dense, torch.tensor([-1, 0]),
                               torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(TypeError):
        apply_ops.scatter_add_(dense, ok_rows,
                               torch.zeros((2, 3), dtype=torch.float32))
    with pytest.raises(ValueError):
        apply_ops.scatter_add_(dense, ok_rows,
                               torch.zeros((2, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        apply_ops.scatter_add_(dense, ok_rows,
                               torch.zeros((3, 2), dtype=torch.float64).t())


# ---------------------------------------------------------------------------
# topk_mag
# ---------------------------------------------------------------------------


def _mags(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.abs(rng.normal(size=n))
    if kind == "ties":                       # exact ties, many of them
        return rng.integers(0, 4, size=n).astype(np.float64)
    if kind == "sub_f32":                    # distinct in f64, equal in f32
        return 1.0 + rng.integers(0, 5, size=n) * 2.0 ** -40
    if kind == "equal":
        return np.full(n, 2.5)
    if kind == "nan":
        return np.full(n, np.nan)
    if kind == "special":                    # every key class, mixed
        return rng.choice(_SPECIALS, size=n)
    raise ValueError(kind)


# +-0, +-inf, NaNs of both signs and several payloads, subnormals, negative
# values, exact ties and values equal in f32 but distinct in f64
_SPECIALS = np.concatenate([
    [0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324, 2.2e-308, -1.0, -3.5,
     1.0, 1.0, 1.0 + 2.0 ** -40, 1.0 + 2.0 ** -41, 7.0, 1e308],
    np.array([0x7FF8000000000000, 0xFFF8000000000000, 0x7FF0000000000001,
              0xFFF0000000000123, 0x7FFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFF],
             dtype=np.uint64).view(np.float64)])


_TOPK_CASES = [("random", 2), ("random", 7), ("random", 300), ("ties", 2),
               ("ties", 130), ("sub_f32", 2), ("sub_f32", 64)]


@pytest.mark.parametrize("kind,n", _TOPK_CASES, ids=lambda v: str(v))
def test_topk_mag_plain_matches_reference_kernel(kind, n, monkeypatch):
    """The reference's Pallas kernel body (interpret mode) plus its f64 tie
    refine is the oracle; the port's plain version must equal it bitwise."""
    monkeypatch.setenv("REPRO_PALLAS", "interpret")
    m = _mags(kind, n)
    want = ref_topk.magnitude_order(m)
    got = topk_ops.magnitude_order(torch.from_numpy(m))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_mag_prefix_and_nan_order(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "off")
    m = np.array([1.0, np.nan, 3.0, 1.0, np.nan, 0.0, -0.0, np.inf])
    want = ref_topk.magnitude_order(m)          # np.argsort(-m, "stable")
    got = topk_ops.magnitude_order(torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        topk_ops.magnitude_order(torch.from_numpy(m), k=3).numpy(), want[:3])
    assert topk_ops.magnitude_order(torch.zeros(0, dtype=torch.float64),
                                    k=0).numel() == 0
    with pytest.raises(ValueError):
        topk_ops.magnitude_order(torch.from_numpy(m), k=9)
    with pytest.raises(TypeError):
        topk_ops.magnitude_order(torch.from_numpy(m).float())


def _by_sort_keys(m):
    """The order the kernel's keys give: (key, index) pairs ascending."""
    keys = topk_ref.sort_keys(torch.from_numpy(m)).numpy().view(np.uint64)
    return np.lexsort((np.arange(m.shape[0]), keys))


_KEY_CASES = ([("specials", _SPECIALS.size)]
              + [(kind, n) for kind in ("random", "ties", "sub_f32", "special")
                 for n in (1, 2, 33, 4096)])


@pytest.mark.parametrize("kind,n", _KEY_CASES, ids=lambda v: str(v))
def test_topk_mag_sort_keys_order_like_argsort(kind, n):
    """The CUDA kernel sorts (sort_keys(m), index) pairs; that order must be
    np.argsort(-m, kind="stable") bitwise, and so must the plain version."""
    m = _SPECIALS.copy() if kind == "specials" else _mags(kind, n, seed=n)
    if kind == "random":
        m = m * np.where(np.arange(n) % 3 == 0, -1.0, 1.0)     # negatives
    want = np.argsort(-m, kind="stable")
    np.testing.assert_array_equal(_by_sort_keys(m), want)
    np.testing.assert_array_equal(
        topk_ref.magnitude_order(torch.from_numpy(m)).numpy(), want)


def test_topk_mag_refuses_2_31_magnitudes_before_launch():
    """Indices travel as uint32: 2**31 magnitudes raise ValueError before
    anything is built or launched (a meta tensor: no memory behind it)."""
    before = topk_ops.launches
    with pytest.raises(ValueError, match="32-bit"):
        topk_ops.magnitude_order(
            torch.empty(2 ** 31, dtype=torch.float64, device="meta"))
    assert topk_ops.launches == before


def test_topk_mag_launches_per_call():
    """One launch up to TILE magnitudes, then one tile sort plus
    ceil(log2(tiles)) merge passes; none when nothing is asked for."""
    t = topk_ops.TILE
    assert [topk_ops.launches_per_call(n) for n in
            (0, 1, 2, 32, 33, t, t + 1, 2 * t, 2 * t + 1, 4 * t,
             (1 << 20) + 5)] == [0, 1, 1, 1, 1, 1, 2, 2, 3, 3,
                                 1 + ((1 << 20) // t).bit_length()]
    assert topk_ops.launches_per_call(5, k=0) == 0


# ---------------------------------------------------------------------------
# vap_accum
# ---------------------------------------------------------------------------

_VAP_N = [64, 8192, 8193, 100_000]      # tests/test_kernels.py's lengths


def _vap_inputs(seed, n, special=False):
    """p, δ, u as float32; ``special`` plants NaN, ±inf and a -0.0 that
    stays -0.0 (its update is -0.0 too) into δ."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1, n).astype(np.float32)
    d = rng.normal(0, 0.01, n).astype(np.float32)
    u = rng.normal(0, 0.01, n).astype(np.float32)
    if special:
        d[n // 7], d[n // 5], d[n // 3], d[n // 2] = (np.nan, np.inf,
                                                     -np.inf, -0.0)
        u[n // 2] = -0.0
    return p, d, u


def _bits(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 2:                # bfloat16 from either side
        return a.view(np.uint16)
    return a.view(np.uint32)


def _assert_same_bits(got, want):
    """Bit patterns equal (so -0.0 is not 0.0), except that a NaN's payload
    and sign are free: NaN must meet NaN at the same places.  Conversions to
    bfloat16 canonicalise NaN differently in torch, XLA and CUDA."""
    got, want = np.asarray(got), np.asarray(want)
    exp = np.uint32(0x7F800000) if got.dtype == np.uint32 else np.uint16(
        0x7F80)
    frac = np.uint32(0x007FFFFF) if got.dtype == np.uint32 else np.uint16(
        0x007F)

    def nan(b):
        return ((b & exp) == exp) & ((b & frac) != 0)

    np.testing.assert_array_equal(nan(got), nan(want))
    keep = ~nan(got)
    np.testing.assert_array_equal(got[keep], want[keep])


def _port_vap(p, d, u, bf16_delta=False):
    tp = torch.from_numpy(p.copy())
    td = torch.from_numpy(d.copy())
    if bf16_delta:
        td = td.to(torch.bfloat16)
    m = vap_ops.vap_accum_(tp, td, torch.from_numpy(u))
    dbits = (td.view(torch.int16).numpy().view(np.uint16) if bf16_delta
             else td.numpy().view(np.uint32))
    return tp.numpy(), dbits, m


@pytest.mark.parametrize("special", [False, True], ids=["normal", "nan_inf"])
@pytest.mark.parametrize("n", _VAP_N)
def test_vap_accum_plain_matches_reference_f32(n, special):
    """float32 δ: the reference's Pallas kernel (interpret mode) and its jnp
    ref are the oracles; p', δ' and the max agree bitwise, NaN included."""
    p, d, u = _vap_inputs(n, n, special)
    got_p, got_d, m = _port_vap(p, d, u)
    assert m.dtype == torch.float32 and m.dim() == 0
    for fn in (lambda *a: ref_vap_kernel.vap_accum_pallas(*a, interpret=True),
               ref_vap.vap_accum):
        want_p, want_d, want_m = fn(jnp.asarray(p), jnp.asarray(d),
                                    jnp.asarray(u))
        _assert_same_bits(_bits(got_p), _bits(want_p))
        _assert_same_bits(got_d, _bits(want_d))
        _assert_same_bits(_bits(m.numpy()), _bits(np.float32(want_m)))
    assert np.isnan(float(m)) == special


@pytest.mark.parametrize("special", [False, True], ids=["normal", "nan_inf"])
@pytest.mark.parametrize("n", _VAP_N)
def test_vap_accum_plain_matches_reference_bf16_delta(n, special):
    """bfloat16 δ with float32 p and u, the sync layer's bf16 accumulator:
    δ' is the float32 sum rounded once (the Pallas kernel's float32 output
    cast to bfloat16, and ``(d + u).astype(bf16)``), and the max is taken of
    the rounded value, as ``tree_max_abs`` takes it."""
    p, d, u = _vap_inputs(n + 1, n, special)
    d = np.asarray(jnp.asarray(d, jnp.bfloat16).astype(jnp.float32))
    got_p, got_d, m = _port_vap(p, d, u, bf16_delta=True)
    jd = jnp.asarray(d, jnp.bfloat16)
    kp, kd, _ = ref_vap_kernel.vap_accum_pallas(
        jnp.asarray(p), jd, jnp.asarray(u), interpret=True)
    nd = (jd + jnp.asarray(u)).astype(jnp.bfloat16)
    _assert_same_bits(_bits(got_p), _bits(kp))
    _assert_same_bits(got_d, _bits(kd.astype(jnp.bfloat16)))
    _assert_same_bits(got_d, _bits(nd))
    want_m = ref_sync.tree_max_abs({"x": nd})
    _assert_same_bits(_bits(m.numpy()), _bits(np.float32(want_m)))


def test_vap_accum_tree_matches_reference():
    tree = {"a": np.ones((4, 4), np.float32), "c": np.zeros(7, np.float32)}
    upd = {"a": np.full((4, 4), 0.5, np.float32),
           "c": np.full(7, -0.25, np.float32)}
    want_p, want_d, want_m = ref_vap_tree(
        {k: jnp.asarray(v) for k, v in tree.items()},
        {k: jnp.zeros_like(v) for k, v in tree.items()},
        {k: jnp.asarray(v) for k, v in upd.items()})
    p = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    d = {k: torch.zeros_like(v) for k, v in p.items()}
    m = vap_ops.vap_accum_tree_(p, d, {k: torch.from_numpy(v)
                                       for k, v in upd.items()})
    assert float(m) == float(want_m) == 0.5
    for k in tree:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(want_p[k]))
        np.testing.assert_array_equal(d[k].numpy(), np.asarray(want_d[k]))
    assert float(vap_ops.vap_accum_tree_({}, {}, {})) == 0.0


def test_vap_accum_rejects_bad_input():
    z = torch.zeros(5)
    with pytest.raises(ValueError):
        vap_ops.vap_accum_(z, torch.zeros(5), torch.zeros(4))
    with pytest.raises(ValueError):
        vap_ops.vap_accum_tree_({"a": z}, {"b": z}, {"a": z})
    # the plain version takes any floating dtype on the CPU
    p64 = torch.zeros(3, dtype=torch.float64)
    m = vap_ops.vap_accum_(p64, torch.zeros(3, dtype=torch.float64),
                           torch.full((3,), -2.0, dtype=torch.float64))
    assert float(m) == 2.0 and m.dtype == torch.float32
    assert float(vap_ops.vap_accum_(torch.zeros(0), torch.zeros(0),
                                    torch.zeros(0))) == 0.0


# ---------------------------------------------------------------------------
# flash_attention, ssd_scan, rglru_scan (the LLM substrate)
# ---------------------------------------------------------------------------

# tests/test_kernels.py's cases: b, sq, skv, kvh, G, dh, dv, window, cap
FLASH_CASES = [
    (2, 256, 256, 2, 2, 64, 64, None, None),
    (2, 256, 256, 2, 2, 64, 64, 100, None),
    (1, 300, 300, 1, 4, 32, 32, None, 50.0),
    (1, 128, 128, 4, 1, 192, 128, None, None),     # MLA: dv != dh
    (1, 512, 512, 1, 1, 128, 128, 64, 30.0),       # window + cap
    (2, 64, 512, 2, 2, 64, 64, None, None),        # q is a suffix (prefill tail)
]
# b, l, h, p, g, n, chunk
SSD_CASES = [
    (2, 64, 4, 8, 2, 16, 16),
    (1, 100, 6, 16, 1, 32, 32),     # padding path
    (2, 256, 4, 64, 2, 128, 64),    # production-like dims
    (1, 32, 2, 8, 2, 8, 32),        # single chunk
]
RGLRU_CASES = [(2, 64, 128), (1, 100, 50), (3, 256, 256), (1, 128, 4096)]
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _ktol(dtype):
    """tests/test_kernels.py's ``_tol``."""
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=5e-5, rtol=1e-4))


def _to_t(a):
    """A JAX array as a torch tensor of the same dtype (bfloat16 exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flash_inputs(case, dtype, seed=0):
    b, sq, skv, kvh, G, dh, dv, window, cap = case
    rng = np.random.default_rng(seed)
    jdt = _DT[dtype][0]
    q = jnp.asarray(rng.normal(0, 1, (b, sq, kvh, G, dh)), jdt)
    k = jnp.asarray(rng.normal(0, 1, (b, skv, kvh, dh)), jdt)
    v = jnp.asarray(rng.normal(0, 1, (b, skv, kvh, dv)), jdt)
    qp = jnp.arange(skv - sq, skv, dtype=jnp.int32)
    kp = jnp.arange(skv, dtype=jnp.int32)
    return (q, k, v, qp, kp), dict(window=window, cap=cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_plain_matches_reference(case, dtype):
    """The port's plain version against the Pallas kernel (interpret mode)
    and the jnp oracle, at tests/test_kernels.py's tolerances."""
    args, kw = _flash_inputs(case, dtype)
    got = fa_ops.flash_attention(*map(_to_t, args), **kw)
    assert got.dtype == _DT[dtype][1]
    assert tuple(got.shape) == case[:2] + (case[3], case[4], case[6])
    pallas = ref_fa_kernel.flash_attention_pallas(*args, **kw, interpret=True)
    oracle = jax.jit(ref_fa.attention, static_argnames=("window", "cap"))(
        *args, **kw)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_ktol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(oracle), **_ktol(dtype))


def test_flash_attention_refuses_batch_positions_and_masks_sentinels():
    args, kw = _flash_inputs(FLASH_CASES[0], "float32")
    q, k, v, qp, kp = map(_to_t, args)
    with pytest.raises(ValueError, match="shared"):
        fa_ops.flash_attention(q, k, v, qp[None].expand(2, -1), kp)
    # padded key slots carry 2**30 and are never seen; a row that sees no
    # key gives 0
    kp2 = kp.clone()
    kp2[100:] = 2**30
    got = fa_ops.flash_attention(q, k, v, qp, kp2)
    want = fa_ref.attention(q[:, :, :, :, :], k[:, :100], v[:, :100], qp,
                            kp2[:100])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    empty = fa_ops.flash_attention(q, k, v, qp - 1000, kp)
    assert float(empty.abs().max()) == 0.0


def _ssd_inputs(case, dtype, seed=0):
    b, l, h, p, g, n, chunk = case
    rng = np.random.default_rng(seed)
    jdt = _DT[dtype][0]
    x = jnp.asarray(rng.normal(0, 1, (b, l, h, p)), jdt)
    dt = jnp.asarray(rng.uniform(0.01, 0.2, (b, l, h)), jnp.float32)
    A = jnp.asarray(-rng.uniform(0.1, 1, (h,)), jnp.float32)
    B = jnp.asarray(rng.normal(0, 1, (b, l, g, n)), jdt)
    C = jnp.asarray(rng.normal(0, 1, (b, l, g, n)), jdt)
    init = jnp.asarray(rng.normal(0, 0.5, (b, h, p, n)), jnp.float32)
    return (x, dt, A, B, C, chunk), init


def _ssd_tol(dtype):
    """tests/test_kernels.py's SSD tolerances: bf16 inputs carry chunk
    states in f32 in the kernel while the oracle's bulk einsums stay bf16."""
    if dtype == "bfloat16":
        return dict(atol=1e-1, rtol=5e-2), dict(atol=1e-2, rtol=1e-2)
    return dict(atol=5e-5, rtol=1e-4), dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_scan_plain_matches_reference(case, dtype):
    args, init = _ssd_inputs(case, dtype)
    targs = [_to_t(a) for a in args[:5]] + [args[5]]
    y, st = ssd_ops.ssd_scan(*targs, initial_state=_to_t(init))
    assert y.dtype == _DT[dtype][1] and st.dtype == torch.float32
    ytol, stol = _ssd_tol(dtype)
    for want_y, want_s in (
            ref_ssd_kernel.ssd_scan_pallas(*args, initial_state=init,
                                           interpret=True),
            jax.jit(ref_ssd.ssd_chunked, static_argnums=5)(
                *args, initial_state=init)):
        np.testing.assert_allclose(_f32(y), _f32(want_y), **ytol)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **stol)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(5)
    b, h, p, n = 2, 4, 8, 16
    arrs = [rng.normal(0, 1, s).astype(np.float32) for s in
            ((b, h, p, n), (b, h, p), (b, h), (h,), (b, h, n), (b, h, n))]
    arrs[2] = np.abs(arrs[2]) * 0.1
    arrs[3] = -np.abs(arrs[3])
    y, new = ssd_ops.ssd_step(*map(torch.from_numpy, arrs))
    want_y, want_new = ref_ssd.ssd_step(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(new.numpy(), np.asarray(want_new), atol=1e-5,
                               rtol=1e-5)


# the bfloat16 kernels' gate against the plain version in float32: y to the
# bfloat16 output's rounding plus float32 summation order, the state to 1e-4
SSD_BF16_GATE = dict(atol=1e-3, rtol=4e-3)


def _split(v):
    """v = hi + lo, hi = bf16(v), lo = bf16(v - hi), both widened."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _ssd_split_emulation(x, dt, A, B, C, chunk, initial_state):
    """The bfloat16 kernels' arithmetic, in float32 torch, one (b, h) chunk
    loop at a time: dt folded into P and w = exp(a_last - a) dt into x, the
    float32 operand of each product split into bf16 hi + lo and multiplied
    twice (C B^T once: its operands are bf16), sums in float32, the state
    carried in float32, y rounded once to x's dtype."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    cs = min(chunk, l)
    xf, Bf, Cf = x.float(), B.float(), C.float()
    y = torch.empty((b, l, h, p))
    fin = torch.empty((b, h, p, n))
    for bi in range(b):
        for hi in range(h):
            gi = hi // (h // g)
            carry = initial_state[bi, hi].float()
            for t0 in range(0, l, cs):
                rows = slice(t0, min(t0 + cs, l))
                d, xs = dt[bi, rows, hi], xf[bi, rows, hi]
                Bs, Cs = Bf[bi, rows, gi], Cf[bi, rows, gi]
                a = torch.cumsum(d * A[hi], 0)
                s_hi, s_lo = _split(carry)
                carried = (Cs @ s_hi.T + Cs @ s_lo.T) * torch.exp(a)[:, None]
                keep = torch.ones((len(d), len(d)), dtype=torch.bool).tril()
                P = torch.where(keep, (Cs @ Bs.T)
                                * torch.exp(a[:, None] - a[None, :]) * d, 0.0)
                p_hi, p_lo = _split(P)
                y[bi, rows, hi] = carried + (p_hi @ xs + p_lo @ xs)
                w_hi, w_lo = _split(torch.exp(a[-1] - a)[:, None] * d[:, None]
                                    * xs)
                carry = (w_hi.T @ Bs + w_lo.T @ Bs) + torch.exp(a[-1]) * carry
            fin[bi, hi] = carry
    return y.to(x.dtype), fin


@pytest.mark.parametrize("case", SSD_CASES + [(1, 600, 24, 64, 1, 128, 256)],
                         ids=str)
def test_ssd_scan_split_precision_holds_the_float32_gate(case):
    """The bfloat16 kernels' precision design, checked on the CPU: with
    every float32 operand split into two bf16 products, y stays within the
    float32 gate of the plain version in float32 and the state within
    1e-4."""
    args, init = _ssd_inputs(case, "bfloat16", seed=1)
    targs = [_to_t(a) for a in args[:5]] + [args[5]]
    init_t = _to_t(init)
    want_y, want_s = ssd_ref.ssd_chunked(*(t.float() for t in targs[:5]),
                                         targs[5], initial_state=init_t)
    y, st = _ssd_split_emulation(*targs, init_t)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(y), want_y.numpy(), **SSD_BF16_GATE)
    np.testing.assert_allclose(st.numpy(), want_s.numpy(), atol=1e-4,
                               rtol=1e-4)


def _rglru_inputs(case, dtype, seed=0):
    b, l, w = case
    rng = np.random.default_rng(seed)
    jdt = _DT[dtype][0]
    a = jnp.asarray(rng.uniform(0.7, 0.999, (b, l, w)), jdt)
    bb = jnp.asarray(rng.normal(0, 0.1, (b, l, w)), jdt)
    init = jnp.asarray(rng.normal(0, 1, (b, w)), jnp.float32)
    return a, bb, init


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES, ids=str)
def test_rglru_linear_recurrence_plain_matches_reference(case, dtype):
    """The port's sequential recurrence against the reference's associative
    scan (tests/test_kernels.py's tolerances); h_last is the last step."""
    a, bb, init = _rglru_inputs(case, dtype)
    h, h_last = rg_ops.linear_recurrence(_to_t(a), _to_t(bb), _to_t(init))
    want_h, want_last = jax.jit(ref_rg.linear_recurrence)(a, bb, init)
    assert h.dtype == _DT[dtype][1] and h_last.dtype == torch.float32
    np.testing.assert_allclose(_f32(h), _f32(want_h), **_ktol(dtype))
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                               atol=1e-2 if dtype == "bfloat16" else 1e-5)
    torch.testing.assert_close(h_last, h[:, -1].float(), rtol=0,
                               atol=0 if dtype == "float32" else 1e-2)


def _rglru_gate_inputs(case, seed=7):
    """x, r, i (b, l, w), Λ (w,) and an initial state (b, w) as float32
    numpy arrays (r and i in (0, 1), as sigmoids give them)."""
    b, l, w = case
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, l, w)).astype(np.float32),
            rng.uniform(0, 1, (b, l, w)).astype(np.float32),
            rng.uniform(0, 1, (b, l, w)).astype(np.float32),
            rng.normal(0, 1, (w,)).astype(np.float32),
            rng.normal(0, 1, (b, w)).astype(np.float32))


def _as(a, dtype):
    """A float32 numpy array as a torch tensor of ``dtype`` (rounded to
    nearest even, as jnp.asarray rounds it)."""
    return torch.from_numpy(a).to(_DT[dtype][1])


# h against the reference's associative scan, which rounds the float32
# state in another order: float32 to 5e-5; bfloat16 to one bf16 unit in the
# last place (2^-7 relative) of the rounded output
_RGLRU_REF_TOL = {"float32": dict(atol=5e-5, rtol=0),
                  "bfloat16": dict(atol=5e-5, rtol=2**-7)}


@pytest.mark.parametrize("init", [False, True], ids=["zeros", "initial"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_gates_and_step_match_reference(dtype, init):
    b, l, w = 2, 96, 64
    *xril, h0 = _rglru_gate_inputs((b, l, w))
    h0 = h0 if init else None
    h, h_last = rg_ops.rglru(*(_as(a, dtype) for a in xril),
                             initial=torch.from_numpy(h0) if init else None)
    x, r, i, lam = (jnp.asarray(a, _DT[dtype][0]) for a in xril)
    want_h, want_last = jax.jit(ref_rg.rglru)(
        x, r, i, lam, jnp.asarray(h0) if init else None)
    assert h.dtype == _DT[dtype][1] and h_last.dtype == torch.float32
    np.testing.assert_allclose(_f32(h), _f32(want_h), **_RGLRU_REF_TOL[dtype])
    np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                               atol=5e-5)
    hs = torch.from_numpy(h0) if init else torch.zeros((b, w))
    hj = jnp.asarray(h0) if init else jnp.zeros((b, w))
    for t in range(4):
        _, hs = rg_ops.rglru_step(hs, *(_as(a[:, t], dtype)
                                        for a in xril[:3]),
                                  _as(xril[3], dtype))
        _, hj = ref_rg.rglru_step(hj, *(a[:, t] for a in (x, r, i)), lam)
        np.testing.assert_allclose(hs.numpy(), np.asarray(hj), atol=1e-6)


_FIRST_CALL = """
import numpy as np, torch
from repro_torch.kernels.rglru_scan import ref
torch.set_num_threads(8)
rng = np.random.default_rng(7)
x, r, i = (rng.normal(0, 1, (2, 96, 64)).astype(np.float32),
           rng.uniform(0, 1, (2, 96, 64)).astype(np.float32),
           rng.uniform(0, 1, (2, 96, 64)).astype(np.float32))
lam = torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))
ins = [torch.from_numpy(v) for v in (x, r, i)]
first, second = ref.rglru_gates(*ins, lam), ref.rglru_gates(*ins, lam)
print(all(torch.equal(u, v) for u, v in zip(first, second)))
"""


def test_rglru_plain_gates_first_call_equals_the_next():
    """The plain gates on the CPU, a fresh process's first call against its
    second, on 8 threads: bitwise equal.  PyTorch's CPU exp (MKL's vector
    math in 2,048-element chunks over the threads) computed a chunk less
    accurately on a process's first multi-threaded call unless the package
    had made one call on one thread first; it showed in a few percent of
    processes, so six run."""
    env = dict(os.environ, PYTHONPATH=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["True"] * 6, outs


def _rglru_refusals(dev):
    """(call, exception) pairs ``rglru`` refuses before any launch: shapes
    everywhere; on the card also mixed or other dtypes and an initial state
    that is not float32."""
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.zeros((2, 8, 16), **f32)
    lam, h0 = torch.zeros(16, **f32), torch.zeros((2, 16), **f32)
    bad = [((x, x[:, :4], x, lam), ValueError),
           ((x, x, x, lam[:8]), ValueError),
           ((x, x, x, lam, h0[:1]), ValueError),
           ((x[0], x[0], x[0], lam), ValueError)]
    if dev.type == "cuda":
        bf = x.bfloat16()
        bad += [((bf, x, x, lam), TypeError),
                ((bf, bf, bf, lam), TypeError),
                ((x, x, x, lam, h0.bfloat16()), TypeError),
                ((x.half(), x.half(), x.half(), lam.half()), TypeError)]
    return bad


@pytest.mark.parametrize("k", range(4))
def test_rglru_refuses_shapes(k):
    args, exc = _rglru_refusals(torch.device("cpu"))[k]
    with pytest.raises(exc):
        rg_ops.rglru(*args)


# ---------------------------------------------------------------------------
# no fallback: a tensor off the CPU goes to the kernel or raises
# ---------------------------------------------------------------------------


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_wrappers_never_fall_back_to_plain(monkeypatch):
    """A tensor that is not on the CPU takes the kernel path: without a
    card that raises, and the plain version is never called instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(apply_ref, "scatter_add_", forbidden)
    monkeypatch.setattr(topk_ref, "magnitude_order", forbidden)
    monkeypatch.setattr(vap_ref, "vap_accum_", forbidden)
    m = torch.empty(3, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        topk_ops.magnitude_order(m)
    dense = torch.empty((4, 2), dtype=torch.float64, device="meta")
    rows = torch.empty(3, dtype=torch.int64, device="meta")
    delta = torch.empty((3, 2), dtype=torch.float64, device="meta")
    with pytest.raises((RuntimeError, NotImplementedError)):
        apply_ops.scatter_add_(dense, rows, delta)
    v = torch.empty(8, dtype=torch.float32, device="meta")
    with pytest.raises((RuntimeError, ValueError)):
        vap_ops.vap_accum_(v, torch.empty_like(v), torch.empty_like(v))

    monkeypatch.setattr(fa_ref, "attention", forbidden)
    monkeypatch.setattr(ssd_ref, "ssd_chunked", forbidden)
    monkeypatch.setattr(rg_ref, "linear_recurrence", forbidden)
    q = torch.empty((1, 4, 1, 2, 8), device="meta")
    k = torch.empty((1, 4, 1, 8), device="meta")
    pos = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        fa_ops.flash_attention(q, k, k, pos, pos)
    x = torch.empty((1, 8, 2, 4), device="meta")
    bc = torch.empty((1, 8, 1, 4), device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        ssd_ops.ssd_scan(x, torch.empty((1, 8, 2), device="meta"),
                         torch.empty(2, device="meta"), bc, bc, 4)
    a = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        rg_ops.linear_recurrence(a, torch.empty_like(a))
    monkeypatch.setattr(rg_ref, "rglru", forbidden)
    monkeypatch.setattr(rg_ref, "rglru_gates", forbidden)
    with pytest.raises(RuntimeError, match="nvcc"):
        rg_ops.rglru(a, a, a, torch.empty(4, device="meta"))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version (bitwise)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", _APPLY_CARD_CASES, ids=str)
def test_ps_apply_kernel_matches_plain(case, dtype, cuda):
    dense, rows, delta = _card_apply_inputs(case, dtype)
    want = apply_ref.scatter_add_(torch.from_numpy(dense.copy()),
                                  torch.from_numpy(rows),
                                  torch.from_numpy(delta))
    got = torch.from_numpy(dense).to(cuda)
    before = apply_ops.launches
    apply_ops.scatter_add_(got, torch.from_numpy(rows).to(cuda),
                           torch.from_numpy(delta).to(cuda))
    torch.cuda.synchronize()
    assert apply_ops.launches == before + (1 if case[2] else 0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle(dense, rows, delta))


@pytest.mark.cuda
def test_ps_apply_kernel_rejects_bad_input(cuda):
    """On the card as on the CPU: a wrong dtype or a non-contiguous tensor
    raises before anything is launched."""
    dense = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    rows = torch.tensor([0, 4], device=cuda)
    before = apply_ops.launches
    with pytest.raises(TypeError):
        apply_ops.scatter_add_(dense, rows, torch.zeros(
            (2, 3), dtype=torch.float32, device=cuda))
    with pytest.raises(TypeError):
        apply_ops.scatter_add_(dense, rows.to(torch.int32), torch.zeros(
            (2, 3), dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        apply_ops.scatter_add_(dense.half(), rows, torch.zeros(
            (2, 3), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        apply_ops.scatter_add_(dense, rows, torch.zeros(
            (3, 2), dtype=torch.float64, device=cuda).t())
    with pytest.raises(ValueError):
        apply_ops.scatter_add_(torch.zeros((3, 4), dtype=torch.float64,
                                           device=cuda).t(), rows,
                               torch.zeros((2, 3), dtype=torch.float64,
                                           device=cuda))
    with pytest.raises(ValueError):
        apply_ops.scatter_add_(dense, torch.tensor([0, 1, 2, 3], device=cuda)
                               [::2], torch.zeros((2, 3), dtype=torch.float64,
                                                  device=cuda))
    with pytest.raises(ValueError):
        apply_ops.scatter_add_(dense, rows.cpu(), torch.zeros(
            (2, 3), dtype=torch.float64, device=cuda))
    with pytest.raises(IndexError):
        apply_ops.scatter_add_(dense, torch.tensor([0, 5], device=cuda),
                               torch.zeros((2, 3), dtype=torch.float64,
                                           device=cuda))
    assert apply_ops.launches == before
    assert not dense.any()


# every regime's edges: one warp (n <= 32), one block (n <= TILE = 4,096),
# tiles and merge passes beyond; 1,024 and 16,384 are edges of other tile
# sizes, kept as plain sizes
_TOPK_CARD_N = [1, 2, 3, 31, 32, 33, 1023, 1024, 1025, 4095, 4096, 4097,
                16_383, 16_384, 16_385, 3 * 16_384 + 7, (1 << 20) + 5]
_TOPK_CARD_CASES = _TOPK_CASES + [("ties", 4096), ("random", 1)] + [
    (kind, n) for n in _TOPK_CARD_N
    for kind in ("random", "ties", "sub_f32", "equal", "nan", "special")
    if (kind, n) not in _TOPK_CASES + [("ties", 4096), ("random", 1)]]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", _TOPK_CARD_CASES, ids=lambda v: str(v))
def test_topk_mag_kernel_matches_plain(kind, n, cuda):
    m = _mags(kind, n, seed=3)
    if n > 4 and kind not in ("equal", "nan"):
        m[n // 3] = np.nan                   # NaN sorts last
    want = topk_ref.magnitude_order(torch.from_numpy(m))
    got = topk_ops.magnitude_order(torch.from_numpy(m).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    k = max(n // 2, 1)
    got_k = topk_ops.magnitude_order(torch.from_numpy(m).to(cuda), k=k)
    assert got_k.shape == (k,)
    np.testing.assert_array_equal(got_k.cpu().numpy(), want.numpy()[:k])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 33, 4096, 4097, 3 * 16_384 + 7])
def test_topk_mag_launch_count(n, cuda):
    """launches grows by launches_per_call: 1 up to TILE (the flush's n = 2
    among them), 1 + ceil(log2(tiles)) beyond; a k = 0 call launches
    nothing."""
    m = torch.from_numpy(_mags("random", n, seed=5)).to(cuda)
    before = topk_ops.launches
    topk_ops.magnitude_order(m)
    torch.cuda.synchronize()
    tiles = -(-n // topk_ops.TILE)
    want = 1 if n <= topk_ops.TILE else 1 + (tiles - 1).bit_length()
    assert topk_ops.launches - before == want == topk_ops.launches_per_call(n)
    assert topk_ops.magnitude_order(m, k=0).numel() == 0
    assert topk_ops.launches - before == want


_VAP_CARD_N = [0, 1, 3, 64, 8192, 8193, 100_000, (1 << 20) + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("bf16_delta", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", _VAP_CARD_N)
def test_vap_accum_kernel_matches_plain(n, bf16_delta, offset, cuda):
    """Bitwise, NaN/±inf/-0.0 included; ``offset`` 1 views every tensor one
    element into its storage, so no pointer is 16-byte aligned and the
    kernel takes its scalar path."""
    p, d, u = _vap_inputs(n + 7, n, special=n >= 8)
    dt = torch.bfloat16 if bf16_delta else torch.float32
    cpu = [torch.from_numpy(p.copy()), torch.from_numpy(d.copy()).to(dt),
           torch.from_numpy(u.copy())]
    want_m = vap_ref.vap_accum_(*cpu)

    def on_card(x):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=cuda)
        view = buf[offset:]
        view.copy_(x)
        return view

    gp, gd, gu = (on_card(x) for x in (torch.from_numpy(p),
                                       torch.from_numpy(d).to(dt),
                                       torch.from_numpy(u)))
    before = vap_ops.launches
    m = vap_ops.vap_accum_(gp, gd, gu)
    torch.cuda.synchronize()
    assert vap_ops.launches == before + 1
    assert m.device.type == "cuda" and m.dtype == torch.float32

    def bits(t):
        t = t.cpu()
        return (t.view(torch.int16).numpy().view(np.uint16) if t.dtype ==
                torch.bfloat16 else t.numpy().view(np.uint32))

    _assert_same_bits(bits(gp), bits(cpu[0]))
    _assert_same_bits(bits(gd), bits(cpu[1]))
    _assert_same_bits(bits(m.reshape(1)), bits(want_m.reshape(1)))


@pytest.mark.cuda
def test_vap_accum_kernel_refuses_other_dtypes(cuda):
    x = torch.zeros(4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        vap_ops.vap_accum_(x, x.clone(), x.clone())
    y = torch.zeros(4, device=cuda)
    with pytest.raises(TypeError):
        vap_ops.vap_accum_(y, y.clone().half(), y.clone())
    with pytest.raises(ValueError, match="overlap"):
        vap_ops.vap_accum_(y, y, y.clone())


# (flash case, dtype) at the stress cases and a RecurrentGemma-like MQA
# shape: d 256, 16 query heads on one kv head, window, padded tails; then
# the edges of the bfloat16 tensor-core kernel: each head-dim tier (16-64,
# 65-128, 129-256 padded with zeros), dv above and below dh, sq and skv off
# its 128-row and 64-key tiles, a q suffix, and the serve call's window
_FLASH_CARD = ([(c, d) for c in FLASH_CASES for d in ("float32", "bfloat16")]
               + [((2, 333, 333, 1, 16, 256, 256, 128, None), "bfloat16"),
                  ((1, 96, 1000, 1, 16, 256, 256, None, 20.0), "float32")]
               + [(c, "bfloat16") for c in (
                   (1, 200, 200, 2, 2, 16, 16, None, None),
                   (1, 130, 130, 1, 2, 48, 80, 50, None),
                   (2, 257, 257, 2, 4, 256, 256, None, None),
                   (1, 128, 1000, 2, 2, 128, 64, None, None),
                   (1, 333, 1000, 1, 16, 256, 256, 300, None),
                   (1, 257, 257, 1, 16, 256, 256, 100, None),
                   (1, 200, 200, 1, 16, 256, 256, None, 30.0),
                   (1, 4096, 4096, 1, 16, 256, 256, 2048, None))])


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", _FLASH_CARD, ids=str)
def test_flash_attention_kernel_matches_plain(case, dtype, cuda):
    args, kw = _flash_inputs(case, dtype, seed=1)
    q, k, v, qp, kp = (_to_t(a).to(cuda) for a in args)
    want = fa_ref.attention(q, k, v, qp, kp, **kw)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1 and got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                               **_ktol(dtype))
    kp2 = kp.clone()
    kp2[kp.shape[0] // 2:] = 2**30                 # empty ring slots
    got2 = fa_ops.flash_attention(q, k, v, qp, kp2, **kw)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 2 and got2.dtype == q.dtype
    torch.testing.assert_close(
        got2.float(), fa_ref.attention(q, k, v, qp, kp2, **kw).float(),
        **_ktol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_without_keys_gives_zeros(dtype, cuda):
    """skv = 0: every row sees no key and gives 0, on either entry (TMA
    cannot map an empty tensor, so the wrapper answers without a launch)."""
    q = torch.ones((1, 5, 1, 2, 32), dtype=dtype, device=cuda)
    k = torch.ones((1, 0, 1, 32), dtype=dtype, device=cuda)
    got = fa_ops.flash_attention(q, k, k, torch.arange(5, device=cuda),
                                 torch.arange(0, device=cuda))
    want = fa_ref.attention(q, k, k, torch.arange(5, device=cuda),
                            torch.arange(0, device=cuda))
    assert got.dtype == dtype and float(got.abs().max()) == 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dv", [(24, 24), (64, 40), (272, 256), (256, 272)],
                         ids=str)
def test_flash_attention_bf16_refuses_head_dims_and_launches_nothing(
        dh, dv, cuda):
    """The tensor-core kernel takes dh and dv multiples of 16 up to 256;
    anything else raises before a launch, with no plain fallback."""
    q = torch.zeros((1, 8, 1, 2, dh), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 8, 1, dh), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros((1, 8, 1, dv), dtype=torch.bfloat16, device=cuda)
    pos = torch.arange(8, device=cuda)
    before = fa_ops.launches
    with pytest.raises(ValueError, match="multiples of 16"):
        fa_ops.flash_attention(q, k, v, pos, pos)
    assert fa_ops.launches == before


# beyond SSD_CASES on the card: the serve call's widths at one chunk of 600
# steps; a chunk of 100 (not a multiple of 16); 4 heads a group with a
# padded tail; the serve call's width at one request; p and n off the
# 8-element rows and p * n off 4 (the element-by-element loads and stores)
SSD_CARD_CASES = [(1, 600, 24, 64, 1, 128, 256), (1, 100, 4, 64, 1, 128, 256),
                  (2, 1000, 8, 64, 2, 128, 256),
                  (1, 4096, 24, 64, 1, 128, 256), (1, 77, 3, 10, 1, 7, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES + SSD_CARD_CASES, ids=str)
def test_ssd_scan_kernel_matches_plain(case, dtype, cuda):
    """The kernels keep the TPU kernel's float32 contract (the bfloat16
    entry by splitting each float32 operand of its tensor-core products into
    two bf16 parts), so their oracle is the plain version in float32 on the
    same values (bfloat16 inputs widened exactly): y to the bfloat16
    rounding of the output (2^-9 relative, rtol 4e-3) plus float32
    summation order (atol 1e-3); the final state, float32 on both sides, to
    1e-4.  (The plain version in bfloat16 keeps its bulk einsums in bfloat16
    and differs from both by its own rounding; ``chip_smoke.py`` reports
    that distance.)"""
    args, init = _ssd_inputs(case, dtype, seed=1)
    targs = [_to_t(a).to(cuda) for a in args[:5]] + [args[5]]
    init_t = _to_t(init).to(cuda)
    want_y, want_s = ssd_ref.ssd_chunked(*(t.float() for t in targs[:5]),
                                         targs[5], initial_state=init_t)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd_scan(*targs, initial_state=init_t)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1 and y.dtype == targs[0].dtype
    ytol = (SSD_BF16_GATE if dtype == "bfloat16"
            else dict(atol=5e-5, rtol=1e-4))
    np.testing.assert_allclose(_f32(y.cpu()), want_y.cpu().numpy(), **ytol)
    np.testing.assert_allclose(st.cpu().numpy(), want_s.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 300, 4, 64, 2, 128, 128),
                                  (1, 77, 3, 10, 1, 7, 40)], ids=str)
def test_ssd_scan_reads_column_slices_in_place(case, dtype, cuda):
    """Mamba2 hands x, B and C over as column slices of one projection; the
    kernels read them through their strides (16 bytes at a time in the
    first case, element by element in the second) and give bitwise what
    they give on contiguous copies.  x with its heads not packed is copied
    first, to the same result."""
    b, l, h, p, g, n, chunk = case
    rng = np.random.default_rng(4)
    tdt = _DT[dtype][1]
    proj = torch.from_numpy(rng.normal(0, 1, (b, l, h * p + 2 * g * n)))
    proj = proj.to(tdt).to(cuda)
    x = proj[..., :h * p].reshape(b, l, h, p)
    B = proj[..., h * p:h * p + g * n].reshape(b, l, g, n)
    C = proj[..., h * p + g * n:].reshape(b, l, g, n)
    assert not (x.is_contiguous() or B.is_contiguous())
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, l, h))).float().to(cuda)
    A = torch.from_numpy(-rng.uniform(0.1, 1, (h,))).float().to(cuda)
    init = torch.from_numpy(rng.normal(0, 0.5, (b, h, p, n))).float().to(cuda)
    before = ssd_ops.launches
    y, st = ssd_ops.ssd_scan(x, dt, A, B, C, chunk, initial_state=init)
    want_y, want_s = ssd_ops.ssd_scan(x.contiguous(), dt, A, B.contiguous(),
                                      C.contiguous(), chunk,
                                      initial_state=init)
    x_t = x.transpose(2, 3).contiguous().transpose(2, 3)   # heads strided
    y_t, st_t = ssd_ops.ssd_scan(x_t, dt, A, B, C, chunk, initial_state=init)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 3
    for got_y, got_s in ((y, st), (y_t, st_t)):
        assert got_y.is_contiguous()
        assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, entries", [
    ("bfloat16", ["ssd_chunk_state_bf16", "ssd_state_pass",
                  "ssd_chunk_scan_bf16"]),
    ("float32", ["ssd_scan_f32"])])
def test_ssd_scan_entry_follows_dtype(dtype, entries, cuda, monkeypatch):
    """bfloat16 runs the three tensor-core launches, float32 the
    float32-pipe kernel, and either call counts one launch."""
    called = []
    entry = ssd_ops._entry

    def noting(name):
        called.append(name)
        return entry(name)

    monkeypatch.setattr(ssd_ops, "_entry", noting)
    args, init = _ssd_inputs(SSD_CASES[1], dtype, seed=3)
    targs = [_to_t(a).to(cuda) for a in args[:5]] + [args[5]]
    before = ssd_ops.launches
    ssd_ops.ssd_scan(*targs, initial_state=_to_t(init).to(cuda))
    torch.cuda.synchronize()
    assert called == entries and ssd_ops.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["zeros", "initial"])
@pytest.mark.parametrize("case", RGLRU_CASES + [(4, 333, 4096)], ids=str)
def test_rglru_kernel_matches_plain_bitwise(case, init, cuda):
    a, bb, h0 = _rglru_inputs(case, "float32", seed=2)
    ac, bc, hc = _to_t(a), _to_t(bb), _to_t(h0) if init else None
    want_h, want_last = rg_ref.linear_recurrence(ac, bc, hc)
    before = rg_ops.launches
    by_entry = dict(rg_ops.launches_by_entry)
    h, h_last = rg_ops.linear_recurrence(
        ac.to(cuda), bc.to(cuda), hc.to(cuda) if init else None)
    torch.cuda.synchronize()
    assert rg_ops.launches == before + 1
    assert rg_ops.launches_by_entry == {
        **by_entry, "linear_recurrence_f32":
        by_entry["linear_recurrence_f32"] + 1}
    torch.testing.assert_close(h.cpu(), want_h, rtol=0, atol=0)
    torch.testing.assert_close(h_last.cpu(), want_last, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True], ids=["zeros", "initial"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RGLRU_CASES + [(4, 333, 4096)], ids=str)
def test_rglru_fused_matches_plain_on_the_card(case, dtype, init, cuda,
                                               monkeypatch):
    """The fused entry (gates, recurrence and h's cast in one launch)
    against the plain version run on the card, whose exp, log1p and sqrt
    are the same CUDA math functions: bitwise.  Ragged w (50), l off the
    32-step tile (100, 333), b > 1.  The plain version is never called."""
    *xril, h0 = _rglru_gate_inputs(case, seed=3)
    x, r, i, lam = (_as(a, dtype).to(cuda) for a in xril)
    h0 = torch.from_numpy(h0).to(cuda) if init else None
    want_h, want_last = rg_ref.rglru(x, r, i, lam, h0)

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("rglru", "rglru_gates", "linear_recurrence"):
        monkeypatch.setattr(rg_ref, name, forbidden)
    before = rg_ops.launches
    by_entry = dict(rg_ops.launches_by_entry)
    h, h_last = rg_ops.rglru(x, r, i, lam, h0)
    torch.cuda.synchronize()
    entry = rg_ops.RGLRU_ENTRIES[x.dtype]
    assert rg_ops.launches == before + 1
    assert rg_ops.launches_by_entry == {**by_entry,
                                        entry: by_entry[entry] + 1}
    assert h.dtype == x.dtype and h.shape == x.shape and h.is_contiguous()
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)
    torch.testing.assert_close(h_last, want_last, rtol=0, atol=0)


@pytest.mark.cuda
def test_rglru_sqrt_is_correctly_rounded_on_its_domain(cuda):
    """The fused kernel's branch-free sqrt against __fsqrt_rn on every float
    of the gate's domain [1e-12, 1] (3.4e8 values): no bit differs."""
    fn = _build.entry("rglru_sqrt_mismatches", [
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ctypes.c_void_p])
    lo, hi = (int(np.float32(v).view(np.uint32)) for v in (1e-12, 1.0))
    count = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert fn(torch.cuda.current_device(), lo, hi, count.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert int(count) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(8))
def test_rglru_refusals_launch_nothing(k, cuda):
    args, exc = _rglru_refusals(cuda)[k]
    before = rg_ops.launches
    by_entry = dict(rg_ops.launches_by_entry)
    with pytest.raises(exc):
        rg_ops.rglru(*args)
    assert rg_ops.launches == before
    assert rg_ops.launches_by_entry == by_entry


@pytest.mark.cuda
def test_llm_kernels_refuse_what_they_do_not_take(cuda):
    a = torch.zeros((1, 4, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        rg_ops.linear_recurrence(a, a)
    q = torch.zeros((1, 4, 1, 1, 6), device=cuda)
    k = torch.zeros((1, 4, 1, 6), device=cuda)
    pos = torch.arange(4, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        fa_ops.flash_attention(q, k, k, pos, pos)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), k.half(), pos, pos)
    x = torch.zeros((1, 8, 2, 128), device=cuda)
    bc = torch.zeros((1, 8, 1, 16), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ssd_ops.ssd_scan(x, torch.zeros((1, 8, 2), device=cuda),
                         torch.zeros(2, device=cuda), bc, bc, 4)
