"""The gradient of the port's flash attention against the JAX package's, on
the CPU.

``ref.attention_bwd`` (the backward kernel's plain version: the explicit
formulas P, dP = dO V^T, D = rowsum(P dP), dS = P (dP - D), the softcap's
1 - tanh² factor, in float32) is held against ``jax.vjp`` of the JAX
package's ``models/attention.py`` ``attention_core``, the function its train
step differentiates (the reference never calls its flash kernel), on the
same numpy inputs and cotangents: sq 1,024 over the core's 512-row chunks
so that its banded path runs, windows 256 and None, caps None and 30, G 1,
2 and 16, dv != dh, empty key slots (``2**30``) and rows that see no key.
Then the autograd ``Function`` of ``ops`` called directly on CPU tensors
(its backward dispatched to the plain version) against the same oracle,
and ``ref.attention_lse``, the log-sum-exp the kernel's forward writes for
its backward.

Tolerances: float32 rtol 2e-4, atol 2e-5 (summed in other orders).
bfloat16: the core rounds its output to bfloat16 and its vjp rounds the
gradients once more, as the plain version does; a value may land one unit
in the last place apart: rtol 2^-7 (two units), atol 1e-3 of the output's
largest magnitude.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.attention import attention_core
from repro_torch.kernels.flash_attention import ops, ref

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7
SENTINEL = 2**30

# (b, sq, kvh, G, dh, dv, window, cap, empty key slots, dtype)
CASES = [
    (1, 1024, 1, 2, 16, 16, 256, None, False, "float32"),   # banded
    (1, 1024, 1, 16, 8, 8, 256, 30.0, False, "float32"),    # MQA, banded
    (1, 1024, 2, 1, 8, 12, None, None, False, "float32"),   # chunked
    (2, 64, 2, 2, 8, 16, None, 30.0, True, "float32"),      # empty slots
    (1, 96, 1, 2, 16, 8, 20, None, True, "float32"),        # rows see none
    (2, 64, 1, 4, 16, 16, 24, 30.0, False, "bfloat16"),
]


def _ids(case):
    return "-".join(map(str, case))


def _inputs(case, seed=0):
    b, sq, kvh, G, dh, dv, window, cap, empty, dtype = case
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.normal(size=(b, sq, kvh, G, dh)).astype(f)
    k = rng.normal(size=(b, sq, kvh, dh)).astype(f)
    v = rng.normal(size=(b, sq, kvh, dv)).astype(f)
    do = rng.normal(size=(b, sq, kvh, G, dv)).astype(f)
    if dtype == "bfloat16":
        q, k, v, do = (torch.from_numpy(a).bfloat16().float().numpy()
                       for a in (q, k, v, do))
    q_pos = np.arange(sq, dtype=np.int32)
    k_pos = q_pos.copy()
    if empty:
        k_pos[sq // 2:] = SENTINEL
    return q, k, v, q_pos, k_pos, do


def _torch(a, dtype="float32"):
    t = torch.from_numpy(np.asarray(a))
    return t.bfloat16() if dtype == "bfloat16" and t.is_floating_point() \
        else t


def _reference_vjp(case, q, k, v, q_pos, k_pos, do):
    window, cap, dtype = case[6], case[7], case[9]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(q_, k_, v_):
        return attention_core(q_, k_, v_, jnp.asarray(q_pos),
                              jnp.asarray(k_pos), window=window, cap=cap)

    out, vjp = jax.vjp(f, *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(jd))]


def _close(got, want, dtype, name):
    got = got.float().numpy()
    assert got.shape == want.shape, name
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL,
                                   atol=1e-3 * float(np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_attention_bwd_matches_reference_vjp(case):
    q, k, v, q_pos, k_pos, do = _inputs(case)
    window, cap, dtype = case[6], case[7], case[9]
    want = _reference_vjp(case, q, k, v, q_pos, k_pos, do)
    got = ref.attention_bwd(*(_torch(a, dtype) for a in (q, k, v, q_pos,
                                                          k_pos)),
                            window, cap, _torch(do, dtype))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == (torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32), name
        _close(g, w, dtype, name)
    if case[8]:        # every empty slot's key and value take no gradient
        empty = torch.from_numpy(k_pos == SENTINEL)
        assert bool((got[1][:, empty] == 0).all())
        assert bool((got[2][:, empty] == 0).all())


@pytest.mark.parametrize("case", [CASES[1], CASES[4], CASES[5]], ids=_ids)
def test_flash_function_on_cpu_matches_reference_vjp(case):
    """``ops._FlashAttention`` called on CPU tensors: its forward runs the
    plain version (and the log-sum-exp), its backward ``ref.attention_bwd``;
    q_pos, k_pos, window and cap take no gradient."""
    q, k, v, q_pos, k_pos, do = _inputs(case, seed=3)
    window, cap, dtype = case[6], case[7], case[9]
    want = _reference_vjp(case, q, k, v, q_pos, k_pos, do)
    leaves = [_torch(a, dtype).requires_grad_(True) for a in (q, k, v)]
    out = ops._FlashAttention.apply(*leaves, _torch(q_pos), _torch(k_pos),
                                    window, cap)
    assert out.dtype == leaves[0].dtype
    got = torch.autograd.grad(out, leaves, _torch(do, dtype))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4]], ids=_ids)
def test_attention_lse_is_the_rows_log_sum_exp(case):
    """exp(s - lse) sums to 1 over a row's keys, and lse is +inf on a row
    with no key (so that the backward's P is 0 there, never NaN)."""
    q, k, v, q_pos, k_pos, _ = _inputs(case, seed=5)
    window, cap = case[6], case[7]
    qt, kt = _torch(q), _torch(k)
    out, lse, lo = ops.flash_attention(qt, kt, _torch(v), _torch(q_pos),
                                       _torch(k_pos), window, cap,
                                       return_lse=True)
    b, sq, kvh, G = q.shape[:4]
    assert lse.shape == (b, kvh, G, sq) and lse.dtype == torch.float32
    assert lo is None                       # the residual is bfloat16's
    s = np.einsum("bqkgd,bskd->bkgqs", q, k) / math.sqrt(q.shape[-1])
    if cap is not None:
        s = np.tanh(s / cap) * cap
    seen = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        seen &= k_pos[None, :] > q_pos[:, None] - window
    s = np.where(seen, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    none = ~seen.any(-1)
    with np.errstate(divide="ignore"):        # log(0) on a row with none
        want = mx[..., 0] + np.log(np.exp(
            s - np.where(np.isfinite(mx), mx, 0)).sum(-1))
    want = np.where(none, np.inf, want)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    assert bool(torch.isinf(lse).any()) == bool(none.any())
    assert torch.equal(out, ref.attention(qt, kt, _torch(v), _torch(q_pos),
                                          _torch(k_pos), window, cap))


def test_flash_attention_bwd_checks_shapes():
    case = CASES[3]
    q, k, v, q_pos, k_pos, do = (_torch(a) for a in _inputs(case))
    out, lse, _ = ops.flash_attention(q, k, v, q_pos, k_pos, None, 30.0,
                                      return_lse=True)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do[:, 1:])
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse[..., 1:], do)
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(q, k, v, q_pos[None], k_pos, out, lse, do)
    got = ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do,
                                  None, 30.0)
    want = ref.attention_bwd(q, k, v, q_pos, k_pos, None, 30.0, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
