"""The bfloat16 ``ssd_scan`` backward's arithmetic, checked on the CPU.

``backward.cu``'s bfloat16 entry runs every product on the tensor cores in
bfloat16 with float32 accumulation.  An operand that is bfloat16 already (x,
dy, B, C) goes in as it is; every float32 operand (the summed decay-masked
score tiles, the masked C B^T tiles, the split chunk states, w x and
exp(a) dy of the chunk masses) is split into hi = bf16(v) and lo = bf16(v -
hi) and multiplied twice.  C B^T and the dy x^T masks are formed once per
(batch, group) and per head in float32; dB and dC are summed over a
group's heads on chip, in head order, before their products; the decay
exp(a_t - a_s) of a tile pair below the diagonal is exp(a_t - a_r) exp(a_r -
a_s) around the last step r of the column tile.

``_bwd_split_emulation`` is that arithmetic in float32 torch, one (batch,
group) chunk loop at a time, with the heads looped inside a group.  It is
held against the plain version (``ref.ssd_scan_bwd``, autograd through
``ssd_chunked`` in float32) under the kernel's own tolerance
(``tests/test_torch_train_cuda.py``'s ``_assert_close``: 1e-4 max|plain| +
1e-3 |plain|, plus 2^-6 |plain| for a bfloat16 output), over
``test_torch_ssd_grad.CASES`` and Mamba2's layout at a reduced length, and
once against the JAX package's ``jax.vjp`` of ``ssd_chunked``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan import ref as RS
from repro_torch.kernels.ssd_scan import ref

from test_torch_ssd_grad import CASES

TILE = 64                     # the kernel's tile of steps
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
SPLIT_CASES = CASES + [(1, 600, 24, 1, 64, 128, 256, False, False, True)]


def _split(v):
    """v = hi + lo: hi = bf16(v), lo = bf16(v - hi), both widened."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm2(a, b):
    """a @ b with the float32 operand a split into two bf16 products."""
    hi, lo = _split(a)
    return hi @ b + lo @ b


def _decay(a, valid):
    """L[..., t, s] = exp(a_t - a_s) for s <= t < valid: directly within a
    tile, around the column tile's last step r below the diagonal."""
    cs = a.shape[-1]
    idx = torch.arange(cs)
    tile = idx // TILE
    r = torch.clamp((tile + 1) * TILE - 1, max=cs - 1)
    a_r = a[..., r]                                       # per column s
    direct = torch.exp(a[..., :, None] - a[..., None, :])
    around = (torch.exp(a[..., :, None] - a_r[..., None, :])
              * torch.exp(a_r - a)[..., None, :])
    L = torch.where(tile[:, None] > tile[None, :], around, direct)
    keep = (idx[None, :] <= idx[:, None]) & (idx[:, None] < valid)
    return torch.where(keep, L, torch.zeros(()))


def _bwd_split_emulation(x, dt, A, B, C, chunk, init, dy, dfinal):
    """The bfloat16 entry of the ``ssd_scan`` backward in float32 torch.
    Returns (dx, ddt, dA, dB, dC, dinit) as ``ref.ssd_scan_bwd`` does."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hg = h // g
    cs = min(chunk, l)
    nc = -(-l // cs)
    pad = nc * cs - l
    f = torch.float32

    def padded(t):
        t = t.float()
        return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                         1)
    xf, dyf, Bf, Cf, dtf = (padded(t) for t in (x, dy, B, C, dt))
    valid = [min(cs, l - c * cs) for c in range(nc)]
    # (b, h, nc, cs): the chunks' cumsums, constant past l
    a = torch.cumsum((dtf * A.float()).reshape(b, nc, cs, h), 2)
    a = a.permute(0, 3, 1, 2)
    dtc = dtf.reshape(b, nc, cs, h).permute(0, 3, 1, 2)
    xc = xf.reshape(b, nc, cs, h, p).permute(0, 3, 1, 2, 4)
    dyc = dyf.reshape(b, nc, cs, h, p).permute(0, 3, 1, 2, 4)
    Bc = Bf.reshape(b, nc, cs, g, n).permute(0, 3, 1, 2, 4)
    Cc = Cf.reshape(b, nc, cs, g, n).permute(0, 3, 1, 2, 4)
    a_last = a[..., -1]                                   # (b, h, nc)
    w = torch.exp(a_last[..., None] - a)                  # (b, h, nc, cs)
    e = torch.exp(a)
    heads = torch.arange(h) // hg                         # each head's group

    # 1. the chunk masses: (w dt x)^T B and (exp(a) dy)^T C, split
    mass = _mm2((w * dtc)[..., None].mul(xc).transpose(-1, -2),
                Bc[:, heads])                             # (b, h, nc, p, n)
    dmass = _mm2((e[..., None] * dyc).transpose(-1, -2), Cc[:, heads])
    # 2. the passes over chunks in float32
    s_in = torch.empty((b, h, nc, p, n), dtype=f)
    ds_out = torch.empty_like(s_in)
    carry = (torch.zeros((b, h, p, n), dtype=f) if init is None
             else init.float())
    for c in range(nc):
        s_in[:, :, c] = carry
        carry = torch.exp(a_last[..., c])[..., None, None] * carry \
            + mass[:, :, c]
    grad = (torch.zeros((b, h, p, n), dtype=f) if dfinal is None
            else dfinal.float())
    sdot = torch.empty((b, h, nc), dtype=f)
    for c in reversed(range(nc)):
        ds_out[:, :, c] = grad
        sdot[..., c] = torch.exp(a_last[..., c]) * (grad * s_in[:, :, c]
                                                     ).sum((-1, -2))
        grad = torch.exp(a_last[..., c])[..., None, None] * grad \
            + dmass[:, :, c]
    dinit = None if init is None else grad
    s_hi, s_lo = _split(s_in)
    d_hi, d_lo = _split(ds_out)

    # 3. the chunks, a (batch, group) at a time, its heads looped inside
    dx = torch.zeros((b, h, nc, cs, p), dtype=f)
    rs = torch.zeros((b, h, nc, cs), dtype=f)
    q = torch.zeros_like(rs)
    xdot = torch.zeros_like(rs)
    dB = torch.zeros((b, g, nc, cs, n), dtype=f)
    dC = torch.zeros_like(dB)
    for bi in range(b):
        for gi in range(g):
            for c in range(nc):
                Cg, Bg = Cc[bi, gi, c], Bc[bi, gi, c]
                cb = Cg @ Bg.T                           # once per group
                dcb_sum = torch.zeros((cs, cs), dtype=f)
                dcg = torch.zeros((cs, n), dtype=f)
                dbg = torch.zeros((cs, n), dtype=f)
                for hi in range(gi * hg, (gi + 1) * hg):
                    L = _decay(a[bi, hi, c], valid[c])
                    dts = dtc[bi, hi, c]
                    xh, dyh = xc[bi, hi, c], dyc[bi, hi, c]
                    dcb = L * dts[None, :] * (dyh @ xh.T)
                    m = cb * dcb
                    dcb_sum = dcb_sum + dcb               # head order
                    # the carried state's terms
                    v = dyh @ s_hi[bi, hi, c] + dyh @ s_lo[bi, hi, c]
                    eh = e[bi, hi, c]
                    dcg = dcg + eh[:, None] * v
                    rs[bi, hi, c] = m.sum(1) - m.sum(0) \
                        + eh * (v * Cg).sum(1)
                    z = Bg @ d_hi[bi, hi, c].T + Bg @ d_lo[bi, hi, c].T
                    wh = w[bi, hi, c]
                    dxdt = wh[:, None] * z + _mm2((cb * L).T, dyh)
                    u = xh @ d_hi[bi, hi, c] + xh @ d_lo[bi, hi, c]
                    wdt = (wh * dts)[:, None] * u
                    dbg = dbg + wdt
                    q[bi, hi, c] = (wdt * Bg).sum(1)
                    dx[bi, hi, c] = dts[:, None] * dxdt
                    xdot[bi, hi, c] = (xh * dxdt).sum(1)
                dC[bi, gi, c] = _mm2(dcb_sum, Bg) + dcg
                dB[bi, gi, c] = _mm2(dcb_sum.T, Cg) + dbg
    # 4. dA_t: the reverse cumsum of the d a terms plus the q's before t
    ok = (torch.arange(nc * cs) < l).reshape(nc, cs)
    rs, q = rs * ok, q * ok
    rev = torch.flip(torch.cumsum(torch.flip(rs, [-1]), -1), [-1])
    dat = rev + (torch.cumsum(q, -1) - q) + sdot[..., None]
    ddt = A.float()[None, :, None, None] * dat + xdot     # (b, h, nc, cs)
    dA = (dtc * dat * ok).sum((0, 2, 3))

    def steps(t, last):              # (b, k, nc, cs, ...) -> (b, l, k, ...)
        t = t.reshape(t.shape[:2] + (nc * cs,) + last).movedim(1, 2)
        return t[:, :l]
    return (steps(dx, (p,)).to(x.dtype), steps(ddt, ()), dA,
            steps(dB, (n,)).to(B.dtype), steps(dC, (n,)).to(C.dtype), dinit)


def _inputs(case, seed=0):
    """bfloat16 x, B, C, dy (column slices of one tensor where the case
    says so), float32 dt, A and the states, from numpy."""
    b, l, h, g, p, n, chunk, init, dfin, slices = case
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if slices:
        xbc = t(b, l, h * p + 2 * g * n).to(bf)
        x = xbc[..., :h * p].reshape(b, l, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    else:
        x, B, C = t(b, l, h, p).to(bf), t(b, l, g, n).to(bf), \
            t(b, l, g, n).to(bf)
    dt = torch.nn.functional.softplus(t(b, l, h) - 1.0)
    A = -torch.exp(t(h) * 0.5)
    s0 = t(b, h, p, n) if init else None
    dy = t(b, l, h, p).to(bf)
    df = t(b, h, p, n) if dfin else None
    return x, dt, A, B, C, chunk, s0, dy, df


def _assert_close(name, got, want):
    """tests/test_torch_train_cuda.py's tolerance, unchanged."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    g, w = got.float(), want.float()
    tol = 1e-4 * float(w.abs().max()) + 1e-3 * w.abs()
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * w.abs()
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries off, max abs err "
        f"{float((g - w).abs().max())}, max |plain| {float(w.abs().max())}")


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_bwd_split_emulation_holds_the_kernel_gate(case):
    """The split arithmetic against the plain version in float32, at the
    tolerance the kernel is held to on the card."""
    args = _inputs(case, seed=4)
    got = _bwd_split_emulation(*args)
    want = ref.ssd_scan_bwd(*args)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        _assert_close(name, g, w)


def test_ssd_bwd_split_emulation_matches_reference_vjp():
    """The split arithmetic against ``jax.vjp`` of the JAX package's
    ``ssd_chunked`` (g = 2, an initial state, dfinal, a padded chunk), on
    the same bfloat16-exact values in float32."""
    case = (2, 150, 4, 2, 16, 32, 64, True, True, True)
    x, dt, A, B, C, chunk, s0, dy, df = _inputs(case, seed=7)
    got = _bwd_split_emulation(x, dt, A, B, C, chunk, s0, dy, df)

    def j(t):
        return jnp.asarray(t.float().contiguous().numpy())

    def f(x_, dt_, A_, B_, C_, s_):
        return RS.ssd_chunked(x_, dt_, A_, B_, C_, chunk, initial_state=s_)

    _, vjp = jax.vjp(f, *(j(t) for t in (x, dt, A, B, C, s0)))
    want = vjp((j(dy), j(df)))
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.array(w)).to(g.dtype)
        _assert_close(name, g, w)
