"""The RG-LRU backward kernel's order of work, checked on the CPU.

``backward.cu`` splits the backward over time.  The forward kernel writes
the float32 state entering every 32-step chunk (``ref.rglru_states``).
Stage A walks g's chain g_t = dh_t + a_{t+1} g_{t+1} alone, l-1 ... 0, and
keeps the carry a_{t+1} g_{t+1} entering each chunk from the right, and
dinitial.  Stage B takes every chunk at once: it recomputes the chunk's
states from the saved one, walks the chunk in reverse from its carry, and
writes dx, dr, di and the chunk's partial of dΛ.  A third launch sums the
partials, the chunks in order within a batch row, then the rows.

``_chunked_rglru_bwd`` is that order in float32 torch, every per-element
operation as the kernel rounds it (the gates' exp, exp(2 log a) and sqrt
taken over the whole tensor, as the plain version takes them, since CPU
vector exp may differ from its scalar tail).  It is held against the plain
version (``ref.rglru_bwd``, one sequential sweep): dx, dr, di and dinitial
bitwise, dΛ (summed in another order) within the kernel's gate, chip_smoke's
BWD_TOL: 1e-4 max|plain| + 1e-3 |plain|, plus 2^-6 |plain| in bfloat16.
Cases: ``test_torch_rglru_grad.CASES`` in both dtypes, l at and around the
chunk (1, 31, 32, 33, 100) at w 13 and 40, with and without an initial
state and dh_last, and dh absent.  Then the bare recurrence's order the same
way, the states helper against ``linear_recurrence``'s own states, and the
order once against the JAX package's ``jax.vjp`` at
``test_torch_rglru_grad``'s tolerances.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops, ref

from test_torch_rglru_grad import (CASES, _close, _inputs, _lr_vjp,
                                   _rglru_vjp, _torch)

CHUNK = 32                    # the forward's tile, the backward's chunk
BWD_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-4, 1e-3 + 2**-6)}
DTYPES = ["float32", "bfloat16"]
# (b, l, w, dtype, initial state, dh_last); the dtype is parametrized
EDGE_CASES = [(2, l, w, None, init, init) for l in (1, 31, 32, 33, 100)
              for w in (13, 40) for init in (False, True)]


def _ids(case):
    return "-".join(map(str, case))


def _chain(a, dh, dh_last, l):
    """Stage A: (the carry entering each chunk from the right (b, chunks,
    w), a_0 g_0)."""
    bsz, _, w = a.shape
    chunks = -(-l // CHUNK)
    carries = torch.empty((bsz, chunks, w), dtype=torch.float32)
    carry = (torch.zeros((bsz, w)) if dh_last is None
             else dh_last.float().clone())
    for k in range(chunks - 1, -1, -1):
        carries[:, k] = carry
        for t in range(min(l, (k + 1) * CHUNK) - 1, k * CHUNK - 1, -1):
            g = carry if dh is None else dh[:, t] + carry
            carry = a[:, t] * g
    return carries, carry


def _chunk_states(a, b, states, k, l):
    """The states before each step of chunk k, from its saved state."""
    s = states[:, k]
    prev = []
    for t in range(k * CHUNK, min(l, (k + 1) * CHUNK)):
        prev.append(s)
        s = a[:, t] * s
        s = s + b[:, t]
    return prev


def _sum_partials(parts):
    """dΛ's sum: the chunks in order within a row, then the rows."""
    total = torch.zeros(parts.shape[2])
    for bi in range(parts.shape[0]):
        row = torch.zeros(parts.shape[2])
        for k in range(parts.shape[1]):
            row = row + parts[bi, k]
        total = total + row
    return total


def _chunked_rglru_bwd(x, r_gate, i_gate, a_param, initial, dh, dh_last,
                       c=8.0):
    """The kernel's order: (dx, dr, di, da_param, dinitial)."""
    bsz, l, w = x.shape
    a, gated = ref.rglru_gates(x, r_gate, i_gate, a_param, c)
    lam = a_param.float()
    nsp = -c * F.softplus(lam)
    r32, i32, x32 = r_gate.float(), i_gate.float(), x.float()
    log_a = nsp[None, None, :] * r32
    a2 = torch.exp(2.0 * log_a)
    keep_raw = 1.0 - a2
    sq = torch.sqrt(torch.clamp_min(keep_raw, 1e-12))
    ix = i32 * x32
    dh32 = None if dh is None else dh.float()
    states = ref.rglru_states(x, r_gate, i_gate, a_param, initial, c, CHUNK)
    carries, dinit = _chain(a, dh32, dh_last, l)
    dx, dr, di = (torch.empty((bsz, l, w)) for _ in range(3))
    parts = torch.empty_like(carries)
    for k in range(carries.shape[1]):
        prev = _chunk_states(a, gated, states, k, l)
        carry = carries[:, k]
        dnsp = torch.zeros((bsz, w))
        for n in range(len(prev) - 1, -1, -1):
            t = k * CHUNK + n
            g = carry if dh32 is None else dh32[:, t] + carry
            dix = g * sq[:, t]
            dkeep = torch.where(keep_raw[:, t] >= 1e-12,
                                (g * ix[:, t]) / (2.0 * sq[:, t]), 0.0)
            dlog_a = (g * prev[n]) * a[:, t] + 2.0 * (-dkeep * a2[:, t])
            dx[:, t] = dix * i32[:, t]
            dr[:, t] = dlog_a * nsp
            di[:, t] = dix * x32[:, t]
            dnsp = dnsp + dlog_a * r32[:, t]
            carry = a[:, t] * g
        parts[:, k] = dnsp
    dsp = -c * _sum_partials(parts)
    z = torch.exp(lam)
    dlam = torch.where(lam > 20.0, dsp, dsp * z / (z + 1.0))
    return (dx.to(x.dtype), dr.to(r_gate.dtype), di.to(i_gate.dtype),
            dlam.to(a_param.dtype), None if initial is None else dinit)


def _chunked_linear_recurrence_bwd(a, b, initial, dh, dh_last):
    """The bare recurrence's order: (da, db, dinitial)."""
    bsz, l, w = a.shape
    a32, b32 = a.float(), b.float()
    dh32 = None if dh is None else dh.float()
    states = ref.linear_recurrence_states(a32, b32, initial, CHUNK)
    carries, dinit = _chain(a32, dh32, dh_last, l)
    da, db = torch.empty((bsz, l, w)), torch.empty((bsz, l, w))
    for k in range(carries.shape[1]):
        prev = _chunk_states(a32, b32, states, k, l)
        carry = carries[:, k]
        for n in range(len(prev) - 1, -1, -1):
            t = k * CHUNK + n
            g = carry if dh32 is None else dh32[:, t] + carry
            da[:, t] = g * prev[n]
            db[:, t] = g
            carry = a32[:, t] * g
    return (da.to(a.dtype), db.to(b.dtype),
            None if initial is None else dinit)


def _args(case, dtype, seed=0):
    case = (*case[:3], dtype, *case[4:])
    x, r, i, lam, s0, dh, dl = _inputs(case, seed)
    return (_torch(x, dtype), _torch(r, dtype), _torch(i, dtype),
            _torch(lam, dtype), _torch(s0), _torch(dh, dtype), _torch(dl))


def _within_gate(got, want, name):
    a, r = BWD_TOL[want.dtype]
    g, w = got.float(), want.float()
    tol = a * float(w.abs().max()) + r * w.abs()
    assert got.dtype == want.dtype, name
    assert bool(((g - w).abs() <= tol).all()), (
        f"{name}: max abs err {float((g - w).abs().max())}")


def _assert_chunked_is_plain(got, want):
    for name, g, w in zip(("dx", "dr", "di", "da_param", "dinitial"), got,
                          want):
        if w is None:
            assert g is None, name
        elif name == "da_param":
            _within_gate(g, w, name)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES + EDGE_CASES, ids=_ids)
def test_chunked_order_is_the_plain_backward(case, dtype):
    args = _args(case, dtype)
    _assert_chunked_is_plain(_chunked_rglru_bwd(*args), ref.rglru_bwd(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [(2, 33, 13, None, True, True),
                                  (1, 100, 40, None, False, True)], ids=_ids)
def test_chunked_order_without_dh(case, dtype):
    """Only h_last used: dh is None, g is the carry alone."""
    x, r, i, lam, s0, _, dl = _args(case, dtype, seed=3)
    args = (x, r, i, lam, s0, None, dl)
    _assert_chunked_is_plain(_chunked_rglru_bwd(*args), ref.rglru_bwd(*args))


@pytest.mark.parametrize("case", [(2, 37, 16, None, True, True),
                                  (3, 1, 8, None, False, True),
                                  (2, 100, 40, None, True, False),
                                  (1, 64, 13, None, False, False)], ids=_ids)
def test_chunked_order_of_the_bare_recurrence(case):
    b, l, w = case[:3]
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.5, 0.99, (b, l, w)).astype(np.float32))
    bb = torch.from_numpy(rng.normal(size=(b, l, w)).astype(np.float32))
    _, _, _, _, s0, dh, dl = _args(case, "float32", seed=2)
    for d in (dh, None):
        got = _chunked_linear_recurrence_bwd(a, bb, s0, d, dl)
        want = ref.linear_recurrence_bwd(a, bb, s0, d, dl)
        for name, g, w_ in zip(("da", "db", "dinitial"), got, want):
            assert (g is None and w_ is None) or torch.equal(g, w_), name


@pytest.mark.parametrize("l", [1, 31, 32, 33, 100])
@pytest.mark.parametrize("init", [False, True], ids=["zeros", "initial"])
def test_states_helper_is_the_forward_loop(l, init):
    """``ref.rglru_states`` is ``linear_recurrence``'s own float32 state
    entering every chunk, and ``ops.rglru_with_states`` returns it with the
    plain forward on the CPU."""
    x, r, i, lam, s0, _, _ = _args((2, l, 13, None, init, False), "float32",
                                   seed=5)
    a, gated = ref.rglru_gates(x, r, i, lam)
    h, h_last = ref.linear_recurrence(a, gated, s0)
    states = ref.rglru_states(x, r, i, lam, s0)
    assert states.shape == (2, -(-l // CHUNK), 13)
    assert states.dtype == torch.float32
    first = torch.zeros(2, 13) if s0 is None else s0
    assert torch.equal(states[:, 0], first)
    for k in range(1, states.shape[1]):
        assert torch.equal(states[:, k], h[:, k * CHUNK - 1])
    h2, h_last2, states2 = ops.rglru_with_states(x, r, i, lam, s0)
    assert torch.equal(states2, states) and torch.equal(h_last2, h_last)
    assert torch.equal(h2, ref.rglru(x, r, i, lam, s0)[0])
    _, _, bare = ops.linear_recurrence_with_states(a, gated, s0)
    assert torch.equal(bare, states)


@pytest.mark.parametrize("case", [CASES[1], CASES[5]], ids=_ids)
def test_chunked_order_matches_reference_vjp(case):
    """Once against the JAX package's gradient, through numpy."""
    dtype = case[3]
    x, r, i, lam, s0, dh, dl = _inputs(case, seed=6)
    want = _rglru_vjp(case, x, r, i, lam, s0, dh, dl)
    got = _chunked_rglru_bwd(_torch(x, dtype), _torch(r, dtype),
                             _torch(i, dtype), _torch(lam, dtype),
                             _torch(s0), _torch(dh, dtype), _torch(dl))
    for name, g, w in zip(("dx", "dr", "di", "da_param", "dinitial"), got,
                          want):
        _close(g, w, "float32" if name == "dinitial" else dtype, name)


def test_chunked_bare_order_matches_reference_vjp():
    case = (2, 45, 12, "float32", True, True)
    rng = np.random.default_rng(7)
    a = rng.uniform(0.5, 0.99, (2, 45, 12)).astype(np.float32)
    bb = rng.normal(size=(2, 45, 12)).astype(np.float32)
    _, _, _, _, s0, dh, dl = _inputs(case, seed=8)
    want = _lr_vjp(case, a, bb, s0, dh, dl)
    got = _chunked_linear_recurrence_bwd(_torch(a), _torch(bb), _torch(s0),
                                         _torch(dh), _torch(dl))
    for name, g, w in zip(("da", "db", "dinitial"), got, want):
        _close(g, w, "float32", name)
