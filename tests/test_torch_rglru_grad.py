"""The gradient of the port's RG-LRU against the JAX package's, on the CPU.

``ref.rglru_bwd`` and ``ref.linear_recurrence_bwd`` (the backward kernels'
plain versions: the state recomputed with the forward's loop, then an
explicit reverse sweep in float32) are held against ``jax.vjp`` of the JAX
package's ``rglru_scan/ref.py`` ``rglru`` and ``linear_recurrence`` on the
same numpy inputs and cotangents: float32 and bfloat16 inputs, with and
without an initial state and dh_last, w a multiple of 8 and not.  Then the
autograd ``Function``s of ``ops`` called directly on CPU tensors (their
backward dispatched to the plain versions) against the same oracle: the
saved tensors, the None gradients and the dtype casts.  And the plain
backward against ``torch.autograd`` of the plain forward, bitwise, also
where 1 - a² meets the sqrt's clamp at 1e-12 (torch's ``clamp_min`` passes
the gradient at the tie; JAX's ``maximum`` halves it there).

Tolerances: float32 rtol 2e-4, atol 2e-5 (the reference's associative scan
sums in another order).  bfloat16: both round the same float32 gradient to
bfloat16 once, so a value may land one unit in the last place apart:
rtol 2^-7 (two units), atol 1e-4 of the output's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rglru_scan import ref as R
from repro_torch.kernels.rglru_scan import ops, ref

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (b, l, w, dtype, initial state, dh_last)
CASES = [
    (2, 37, 16, "float32", False, False),
    (2, 37, 13, "float32", True, True),       # w not a multiple of 8
    (1, 64, 24, "float32", True, False),
    (3, 1, 8, "float32", False, True),        # one step
    (2, 37, 16, "bfloat16", False, False),
    (2, 29, 13, "bfloat16", True, True),
    (1, 50, 40, "bfloat16", False, True),
]


def _ids(case):
    return "-".join(map(str, case))


def _inputs(case, seed=0):
    b, l, w, dtype, init, last = case
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, l, w)).astype(f)
    r = rng.uniform(0, 1, (b, l, w)).astype(f)
    i = rng.uniform(0, 1, (b, l, w)).astype(f)
    lam = rng.normal(size=(w,)).astype(f)
    s0 = rng.normal(size=(b, w)).astype(f) if init else None
    dh = rng.normal(size=(b, l, w)).astype(f)
    dl = rng.normal(size=(b, w)).astype(f) if last else None
    # the inputs in their dtype, as float32 numpy arrays of those values
    t = TORCH_DTYPE[dtype]
    x, r, i, lam, dh = (torch.from_numpy(a).to(t).float().numpy()
                        for a in (x, r, i, lam, dh))
    return x, r, i, lam, s0, dh, dl


def _torch(a, dtype="float32"):
    return None if a is None else torch.from_numpy(a).to(TORCH_DTYPE[dtype])


def _jax(a, dtype="float32"):
    return None if a is None else jnp.asarray(a).astype(JAX_DTYPE[dtype])


def _close(got, want, dtype, name=""):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)


def _rglru_vjp(case, x, r, i, lam, s0, dh, dl):
    dtype = case[3]
    args = [_jax(a, dtype) for a in (x, r, i, lam)]
    if s0 is not None:
        args.append(jnp.asarray(s0))

    def f(*a):
        return R.rglru(a[0], a[1], a[2], a[3],
                       initial=a[4] if len(a) > 4 else None)

    (h, h_last), vjp = jax.vjp(f, *args)
    cot_last = (jnp.zeros_like(h_last) if dl is None else jnp.asarray(dl))
    return vjp((_jax(dh, dtype).astype(h.dtype), cot_last))


def _lr_vjp(case, a, b, s0, dh, dl):
    dtype = case[3]
    args = [_jax(a, dtype), _jax(b, dtype)]
    if s0 is not None:
        args.append(jnp.asarray(s0))

    def f(*p):
        return R.linear_recurrence(p[0], p[1],
                                   initial=p[2] if len(p) > 2 else None)

    (h, h_last), vjp = jax.vjp(f, *args)
    cot_last = (jnp.zeros_like(h_last) if dl is None else jnp.asarray(dl))
    return vjp((_jax(dh, dtype).astype(h.dtype), cot_last))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rglru_bwd_matches_reference_vjp(case):
    x, r, i, lam, s0, dh, dl = _inputs(case)
    dtype = case[3]
    want = _rglru_vjp(case, x, r, i, lam, s0, dh, dl)
    got = ref.rglru_bwd(_torch(x, dtype), _torch(r, dtype), _torch(i, dtype),
                        _torch(lam, dtype), _torch(s0), _torch(dh, dtype),
                        _torch(dl))
    assert (got[4] is None) == (s0 is None)
    for name, g, w in zip(("dx", "dr", "di", "da_param", "dinitial"),
                          [t for t in got if t is not None], want):
        assert g.dtype == (torch.float32 if name == "dinitial"
                           else TORCH_DTYPE[dtype]), name
        _close(g, w, "float32" if name == "dinitial" else dtype, name)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_linear_recurrence_bwd_matches_reference_vjp(case):
    b, l, w, dtype = case[:4]
    rng = np.random.default_rng(1)
    t = TORCH_DTYPE[dtype]
    a = torch.from_numpy(rng.uniform(0.5, 0.99, (b, l, w)).astype(
        np.float32)).to(t).float().numpy()
    bb = torch.from_numpy(rng.normal(size=(b, l, w)).astype(
        np.float32)).to(t).float().numpy()
    _, _, _, _, s0, dh, dl = _inputs(case, seed=2)
    want = _lr_vjp(case, a, bb, s0, dh, dl)
    got = ref.linear_recurrence_bwd(_torch(a, dtype), _torch(bb, dtype),
                                    _torch(s0), _torch(dh, dtype), _torch(dl))
    assert (got[2] is None) == (s0 is None)
    for name, g, w_ in zip(("da", "db", "dinitial"),
                           [x for x in got if x is not None], want):
        _close(g, w_, "float32" if name == "dinitial" else dtype, name)


@pytest.mark.parametrize("case", [CASES[1], CASES[5]], ids=_ids)
def test_rglru_function_on_cpu_matches_reference_vjp(case):
    """``ops._RGLRU`` called on CPU tensors: its forward runs the plain
    version, its backward ``ref.rglru_bwd``; the gradients of every input
    against the oracle, and None where an input takes none."""
    x, r, i, lam, s0, dh, dl = _inputs(case, seed=4)
    dtype = case[3]
    want = _rglru_vjp(case, x, r, i, lam, s0, dh, dl)
    leaves = [_torch(a, dtype).requires_grad_(True) for a in (x, r, i, lam)]
    leaves.append(_torch(s0).requires_grad_(True))
    h, h_last = ops._RGLRU.apply(*leaves, 8.0)
    assert h.dtype == TORCH_DTYPE[dtype] and h_last.dtype == torch.float32
    got = torch.autograd.grad([h, h_last], leaves,
                              [_torch(dh, dtype), _torch(dl)])
    for name, g, w in zip(("dx", "dr", "di", "da_param", "dinitial"), got,
                          want):
        _close(g, w, "float32" if name == "dinitial" else dtype, name)
    # only h_last used: dh is None to the backward; no initial state
    leaves = [_torch(a, dtype).requires_grad_(True) for a in (x, r, i, lam)]
    _, h_last = ops._RGLRU.apply(*leaves, None, 8.0)
    got = torch.autograd.grad(h_last.sum(), leaves)
    want = ref.rglru_bwd(*(t.detach() for t in leaves), None, None,
                         torch.ones_like(h_last))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_linear_recurrence_function_on_cpu_matches_reference_vjp():
    case = (2, 21, 12, "float32", True, True)
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 0.99, (2, 21, 12)).astype(np.float32)
    bb = rng.normal(size=(2, 21, 12)).astype(np.float32)
    _, _, _, _, s0, dh, dl = _inputs(case, seed=6)
    want = _lr_vjp(case, a, bb, s0, dh, dl)
    leaves = [_torch(t).requires_grad_(True) for t in (a, bb, s0)]
    h, h_last = ops._LinearRecurrence.apply(*leaves)
    got = torch.autograd.grad([h, h_last], leaves, [_torch(dh), _torch(dl)])
    for g, w in zip(got, want):
        _close(g, w, "float32")
    # the initial state takes no gradient when it is not given
    leaves = [_torch(t).requires_grad_(True) for t in (a, bb)]
    h, _ = ops._LinearRecurrence.apply(*leaves, None)
    assert len(torch.autograd.grad(h.sum(), leaves)) == 2


@pytest.mark.parametrize("clamp", [False, True], ids=["gates", "clamp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_bwd_is_autograd_of_the_plain_forward(dtype, clamp):
    """The explicit sweep takes autograd's ops in autograd's order, so it is
    its gradient bit for bit, also where 1 - a² is clamped (a within 1e-12
    of 1: Λ far below 0, r near 0) and at the clamp's tie."""
    rng = np.random.default_rng(7)
    b, l, w = 2, 19, 24
    t = TORCH_DTYPE[dtype]
    x = torch.from_numpy(rng.normal(size=(b, l, w)).astype(np.float32)).to(t)
    r = torch.from_numpy(rng.uniform(0, 1, (b, l, w)).astype(np.float32))
    lam = torch.from_numpy(rng.normal(size=(w,)).astype(np.float32))
    if clamp:
        r = r * 1e-3
        lam = torch.full((w,), -30.0)
    r, lam = r.to(t), lam.to(t)
    i = torch.from_numpy(rng.uniform(0, 1, (b, l, w)).astype(np.float32)).to(t)
    s0 = torch.from_numpy(rng.normal(size=(b, w)).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=(b, l, w)).astype(np.float32)).to(t)
    dl = torch.from_numpy(rng.normal(size=(b, w)).astype(np.float32))
    leaves = [a.clone().requires_grad_(True) for a in (x, r, i, lam, s0)]
    h, h_last = ref.rglru(*leaves)
    if clamp:   # some steps clamped, some at the tie or above
        a2 = torch.exp(2.0 * (-8.0 * torch.nn.functional.softplus(
            lam.float()) * r.float()))
        assert bool(((1.0 - a2) < 1e-12).any())
    want = torch.autograd.grad([h, h_last], leaves, [dh, dl])
    got = ref.rglru_bwd(x, r, i, lam, s0, dh, dl)
    for name, g, w_ in zip(("dx", "dr", "di", "da_param", "dinitial"), got,
                           want):
        if name == "da_param":     # summed over (b, l) in another order
            np.testing.assert_allclose(g.float().numpy(), w_.float().numpy(),
                                       rtol=BF16_RTOL if dtype == "bfloat16"
                                       else 1e-5, atol=1e-6)
        else:
            assert torch.equal(g, w_), name


def test_rglru_bwd_checks_shapes():
    x, r, i, lam, s0, dh, dl = _inputs(CASES[1])
    args = [_torch(a) for a in (x, r, i, lam, s0)]
    with pytest.raises(ValueError):
        ops.rglru_bwd(*args, _torch(dh)[:, :-1])
    with pytest.raises(ValueError):
        ops.rglru_bwd(*args, _torch(dh), torch.zeros(1, 2))
    with pytest.raises(ValueError):
        ops.linear_recurrence_bwd(args[0], args[1], None, _torch(dh),
                                  torch.zeros(3, 3))
