"""The gradient of the port's ``ssd_scan`` against the JAX package's, on the
CPU, and autograd through the other kernels' wrappers on CPU tensors.

``ref.ssd_scan_bwd`` (the backward kernel's plain version: autograd through
``ssd_chunked`` in float32) is held against ``jax.vjp`` of the JAX
package's ``ssd_chunked`` on the same numpy inputs and cotangents: l a
multiple of the chunk and not (padding), g = 1 and g = 2 with h = 4, with
and without an initial state, a zero and a non-zero ``dfinal``, and x, B, C
as column slices of one tensor (Mamba2's ``xBC``).  Tolerance: rtol 2e-4,
atol 2e-5 (float32, summed in other orders).  Then ``ops.ssd_scan`` on CPU
tensors is differentiated by autograd to the same numbers, and
``flash_attention`` / ``rglru`` / ``linear_recurrence`` on CPU tensors that
require grad are their plain versions, which autograd differentiates (on
the card each is an autograd ``Function`` with a backward kernel,
``tests/test_torch_train_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan import ref as RS
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.kernels.ssd_scan import ops, ref

RTOL, ATOL = 2e-4, 2e-5

# (b, l, h, g, p, n, chunk, initial state, dfinal, column slices)
CASES = [
    (2, 32, 4, 1, 8, 6, 8, False, False, False),     # l a multiple of chunk
    (2, 37, 4, 1, 8, 6, 8, False, True, False),      # padded last chunk
    (1, 30, 4, 2, 4, 5, 16, True, True, False),      # g = 2, initial state
    (2, 24, 4, 2, 8, 4, 8, True, False, True),       # column slices
    (1, 5, 2, 1, 3, 4, 16, False, True, True),       # one short chunk
]


def _inputs(case, seed=0):
    b, l, h, g, p, n, chunk, init, dfin, slices = case
    rng = np.random.default_rng(seed)
    f = np.float32
    if slices:
        xbc = rng.normal(size=(b, l, h * p + 2 * g * n)).astype(f)
    else:
        xbc = None
    x = (xbc[..., :h * p].reshape(b, l, h, p) if slices
         else rng.normal(size=(b, l, h, p)).astype(f))
    B = (xbc[..., h * p:h * p + g * n].reshape(b, l, g, n) if slices
         else rng.normal(size=(b, l, g, n)).astype(f))
    C = (xbc[..., h * p + g * n:].reshape(b, l, g, n) if slices
         else rng.normal(size=(b, l, g, n)).astype(f))
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)) - 1.0)).astype(f)
    A = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(f)
    s0 = rng.normal(size=(b, h, p, n)).astype(f) if init else None
    dy = rng.normal(size=(b, l, h, p)).astype(f)
    df = rng.normal(size=(b, h, p, n)).astype(f) if dfin else None
    return xbc, x, dt, A, B, C, s0, dy, df, chunk


def _reference_vjp(x, dt, A, B, C, s0, dy, df, chunk):
    b, l, h, p = x.shape
    n = B.shape[-1]
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    init = jnp.asarray(s0) if s0 is not None else None

    def f(x_, dt_, A_, B_, C_, *s):
        return RS.ssd_chunked(x_, dt_, A_, B_, C_, chunk,
                              initial_state=s[0] if s else None)

    cot = (jnp.asarray(dy), jnp.asarray(df) if df is not None
           else jnp.zeros((b, h, p, n), jnp.float32))

    @jax.jit
    def grads(cot, *primals):
        return jax.vjp(f, *primals)[1](cot)

    return [np.asarray(g) for g in
            grads(cot, *args, *([init] if init is not None else []))]


def _torch(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _port_inputs(xbc, x, B, C, case):
    """x, B, C as torch tensors; column slices of one tensor where the case
    says so."""
    b, l, h, g, p, n = case[:6]
    if xbc is None:
        return torch.from_numpy(x), torch.from_numpy(B), torch.from_numpy(C)
    t = torch.from_numpy(xbc)
    return (t[..., :h * p].reshape(b, l, h, p),
            t[..., h * p:h * p + g * n].reshape(b, l, g, n),
            t[..., h * p + g * n:].reshape(b, l, g, n))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_bwd_matches_reference_vjp(case):
    xbc, x, dt, A, B, C, s0, dy, df, chunk = _inputs(case)
    want = _reference_vjp(x, dt, A, B, C, s0, dy, df, chunk)
    xt, Bt, Ct = _port_inputs(xbc, x, B, C, case)
    if xbc is not None:
        assert not xt.is_contiguous() and not Bt.is_contiguous()
    got = ref.ssd_scan_bwd(xt, _torch(dt), _torch(A), Bt, Ct, chunk,
                           _torch(s0), _torch(dy), _torch(df))
    assert (got[5] is None) == (s0 is None)
    names = ["dx", "ddt", "dA", "dB", "dC", "dinit"]
    for name, g, w in zip(names, [t for t in got if t is not None], want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES[1:4],
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_on_cpu_is_differentiated_by_autograd(case):
    """The CPU path of ``ops.ssd_scan`` is the plain version itself; its
    autograd gradient is the backward's plain version, and so the JAX
    package's."""
    xbc, x, dt, A, B, C, s0, dy, df, chunk = _inputs(case, seed=3)
    want = _reference_vjp(x, dt, A, B, C, s0, dy, df, chunk)
    leaves = [_torch(a).requires_grad_(True)
              for a in (x, dt, A, B, C) + ((s0,) if s0 is not None else ())]
    y, fin = ops.ssd_scan(*leaves[:5], chunk,
                          initial_state=leaves[5] if s0 is not None else None)
    outs, seeds = [y], [_torch(dy)]
    if df is not None:
        outs.append(fin)
        seeds.append(_torch(df))
    got = torch.autograd.grad(outs, leaves, seeds)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_ssd_scan_bwd_checks_shapes():
    xbc, x, dt, A, B, C, s0, dy, df, chunk = _inputs(CASES[0])
    with pytest.raises(ValueError):
        ops.ssd_scan_bwd(_torch(x), _torch(dt), _torch(A), _torch(B),
                         _torch(C), chunk, None, _torch(dy)[:, :-1])
    with pytest.raises(ValueError):
        ops.ssd_scan_bwd(_torch(x), _torch(dt), _torch(A), _torch(B),
                         _torch(C), chunk, None, _torch(dy),
                         torch.zeros(1, 2, 3, 4))


def _grads(fn, leaves):
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out.square().sum(), leaves)


def test_gradient_guard_lets_cpu_flash_attention_through():
    rng = np.random.default_rng(0)
    b, s, kvh, G, d = 1, 12, 1, 2, 8
    q, k, v = (torch.tensor(rng.normal(size=sh), dtype=torch.float32,
                            requires_grad=True)
               for sh in ((b, s, kvh, G, d), (b, s, kvh, d), (b, s, kvh, d)))
    pos = torch.arange(s, dtype=torch.int32)
    got = _grads(lambda *t: flash_ops.flash_attention(*t, pos, pos, window=5),
                 [q, k, v])
    want = _grads(lambda *t: flash_ref.attention(*t, pos, pos, window=5),
                  [q, k, v])
    for g, w in zip(got, want):
        assert torch.equal(g, w) and bool(g.abs().sum() > 0)


def test_gradient_guard_lets_cpu_rglru_through():
    rng = np.random.default_rng(1)
    b, l, w = 2, 9, 16
    x, r, i = (torch.tensor(rng.normal(size=(b, l, w)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    r_gate = torch.sigmoid(r)
    i_gate = torch.sigmoid(i)
    a_param = torch.tensor(rng.normal(size=(w,)), dtype=torch.float32,
                           requires_grad=True)
    leaves = [x, r, i, a_param]
    got = _grads(lambda x_, r_, i_, a_: rg_ops.rglru(
        x_, torch.sigmoid(r_), torch.sigmoid(i_), a_), leaves)
    want = _grads(lambda x_, r_, i_, a_: rg_ref.rglru(
        x_, torch.sigmoid(r_), torch.sigmoid(i_), a_), leaves)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_) and bool(g.abs().sum() > 0)
    a = torch.rand(b, l, w, requires_grad=True)
    bb = torch.randn(b, l, w, requires_grad=True)
    got = _grads(rg_ops.linear_recurrence, [a, bb])
    want = _grads(rg_ref.linear_recurrence, [a, bb])
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    del r_gate, i_gate
