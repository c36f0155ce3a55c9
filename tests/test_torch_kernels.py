"""The port's kernels against the JAX package's, and against their plain
versions on the card.

On the CPU each wrapper runs its plain PyTorch version, which is held
bitwise against the reference's oracle: ``np.add.at`` for the shard apply
(the reference's ``scatter_add_inplace`` with ``REPRO_PALLAS=off``; its
Pallas path no longer runs under the installed jax) and the Pallas
``topk_mag`` kernel plus its f64 refine (``REPRO_PALLAS=interpret``) for the
send order.  The ``cuda``-marked cases build the CUDA kernels and hold them
bitwise against the plain versions on CPU copies of the same inputs; they
skip on a host without a CUDA device.
"""
import numpy as np
import pytest
import torch

from repro.kernels.ps_apply import ops as ref_apply
from repro.kernels.topk_mag import ops as ref_topk
from repro_torch.kernels import resolve_device
from repro_torch.kernels.ps_apply import ops as apply_ops
from repro_torch.kernels.ps_apply import ref as apply_ref
from repro_torch.kernels.topk_mag import ops as topk_ops
from repro_torch.kernels.topk_mag import ref as topk_ref


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


@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", _APPLY_CASES, ids=str)
def test_ps_apply_plain_matches_reference(case, dtype, monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS", "off")
    dense, rows, delta = _apply_inputs(0, *case, dtype)
    want = dense.copy()
    ref_apply.scatter_add_inplace(want, rows, delta)    # == np.add.at
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
    raise ValueError(kind)


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
    m = torch.empty(3, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        topk_ops.magnitude_order(m)
    dense = torch.empty((4, 2), dtype=torch.float64, device="meta")
    rows = torch.empty(3, dtype=torch.int64, device="meta")
    delta = torch.empty((3, 2), dtype=torch.float64, device="meta")
    with pytest.raises((RuntimeError, NotImplementedError)):
        apply_ops.scatter_add_(dense, rows, delta)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version (bitwise)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", _APPLY_CASES + [(2000, 257, 5000)], ids=str)
def test_ps_apply_kernel_matches_plain(case, dtype, cuda):
    dense, rows, delta = _apply_inputs(2, *case, dtype, sentinel=True)
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", _TOPK_CASES + [("ties", 4096),
                                                  ("random", 1)],
                         ids=lambda v: str(v))
def test_topk_mag_kernel_matches_plain(kind, n, cuda):
    m = _mags(kind, n, seed=3)
    if n > 4:
        m[n // 3] = np.nan                   # NaN sorts last
    want = topk_ref.magnitude_order(torch.from_numpy(m))
    got = topk_ops.magnitude_order(torch.from_numpy(m).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    k = max(n // 2, 1)
    got_k = topk_ops.magnitude_order(torch.from_numpy(m).to(cuda), k=k)
    np.testing.assert_array_equal(got_k.cpu().numpy(), want.numpy()[:k])
