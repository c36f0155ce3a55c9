"""The bfloat16 ``flash_attention`` backward's arithmetic, checked on the CPU.

``backward.cu``'s bfloat16 entry runs every product on the tensor cores in
bfloat16 with float32 accumulation.  S = Q K^T and dP = dO V^T take the
bfloat16 inputs as they are; P = exp(s - lse) (the forward's log-sum-exp,
the logits scaled and soft-capped as the forward caps them) and dS = P
scale (1 - tanh^2) (dP - D) are formed in float32, with D = rowsum(dO O)
from the forward's bfloat16 output plus the rounding residual the forward
writes beside it for training, and rounded to bfloat16 as the operand
of dV += P^T dO, dK += dS^T Q and dQ += dS K.  dK and dV are summed over
64-row query tiles in order and, within each, over the heads of a slice of
the G heads in order; the slices' float32 partials are then added in slice
order (the slice count as the kernel picks it on a 132-SM card).  dQ is
summed over 64-key tiles in order.

``_bwd_bf16_emulation`` is that arithmetic in float32 torch.  It is held
against the plain version (``ref.attention_bwd``, the float32 formulas)
under the kernel's own gate (``tests/test_torch_train_cuda.py``'s
``_assert_close(flash=True)``: 1e-2 max|plain| + 2^-6 |plain|) over
``test_torch_flash_grad.CASES`` and ``test_torch_train_cuda.FLASH_CASES`` in
bfloat16 (among them Gemma2-9B's train layout at 600 positions: 8 kv
heads, G 2, d 256, softcap 50, windowed below one tile and global; and
DeepSeek-V2-Lite's MLA: G 1, q / k 192, v 128, causal) and
RecurrentGemma-9B's layout at reduced lengths (MQA, G 16, d 256, a window
below sq, sq not a multiple of the tile), and once against
the JAX package's ``jax.vjp`` of ``attention_core``, on inputs made with
numpy from a seed.  With the output's rounding residual, D is taken from
the forward's float32 output, and where dP and D nearly cancel
(near-uniform attention over values with a large common mean, as at
MusicGen-medium's last layer) that keeps the gradients within the gate
where D from the bfloat16 output alone does not.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.attention import attention_core
from repro_torch.kernels.flash_attention import ops, ref

from test_torch_flash_grad import CASES as GRAD_CASES
from test_torch_train_cuda import FLASH_CASES

TILE = 64                  # the kernels' key tile and query rows a step
SMS = 132                  # an H100's multiprocessors
LOG2E = 1.4426950408889634
SENTINEL = 2**30
NAMES = ("dq", "dk", "dv")

# (b, sq, skv, kvh, G, dh, dv, window, cap, empty key slots)
RG_CASES = [(1, 600, 600, 1, 16, 256, 256, 256, None, False),
            (2, 333, 333, 1, 16, 256, 256, 100, None, False)]
CASES = ([(b, sq, sq, kvh, G, dh, dv, w, cap, empty)
          for b, sq, kvh, G, dh, dv, w, cap, empty, _ in GRAD_CASES]
         + FLASH_CASES + RG_CASES)


def _slices(b, sq, skv, kvh, G, dh, dv):
    """The kernel's split of the G heads for the dK / dV grid (kv_slices in
    backward.cu): about four blocks an SM, each slice's float32 partials
    within dq's bytes."""
    blocks = b * kvh * -(-skv // TILE)
    s = min(-(-4 * SMS // blocks), G,
            (2 * b * sq * kvh * G * dh) // (4 * b * skv * kvh * (dh + dv)))
    return 1 if s < 2 else s


def _bwd_bf16_emulation(q, k, v, q_pos, k_pos, window, cap, out, lse, do,
                        out_lo):
    """The bfloat16 entry of the flash_attention backward in float32 torch:
    q, k, v, out, do and the residual ``out_lo`` bfloat16, lse float32 (b,
    kvh, G, sq).  Returns (dq, dk, dv) in bfloat16."""
    b, sq, kvh, G, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o = out.float() + out_lo.float()
    dsum = (o * dof).sum(-1).permute(0, 2, 3, 1)              # (b, kvh, G, sq)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)
    x = s * scale
    dcap = torch.ones_like(x)
    if cap is not None:
        t = torch.tanh(x / cap)
        x, dcap = t * cap, 1.0 - t * t
    qp, kp = q_pos.long()[:, None], k_pos.long()[None, :]
    keep = kp <= qp
    if window is not None:
        keep &= kp > qp - window
    p = torch.where(keep, torch.exp2(x * LOG2E - (lse * LOG2E)[..., None]),
                    torch.zeros(()))
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * dcap * scale * (dp - dsum[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()

    n_slices = _slices(b, sq, skv, kvh, G, dh, dv)
    dk = torch.zeros(b, kvh, skv, dh)
    dvv = torch.zeros(b, kvh, skv, dv)
    for sl in range(n_slices):
        pk, pv = torch.zeros_like(dk), torch.zeros_like(dvv)
        for t0 in range(0, sq, TILE):
            rows = slice(t0, t0 + TILE)
            for g in range(sl * G // n_slices, (sl + 1) * G // n_slices):
                pk += torch.einsum("bkqs,bqkd->bksd", ds16[:, :, g, rows],
                                   qf[:, rows, :, g])
                pv += torch.einsum("bkqs,bqkd->bksd", p16[:, :, g, rows],
                                   dof[:, rows, :, g])
        dk += pk
        dvv += pv
    dq = torch.zeros(b, sq, kvh, G, dh)
    for k0 in range(0, skv, TILE):
        cols = slice(k0, k0 + TILE)
        dq += torch.einsum("bkgqs,bskd->bqkgd", ds16[..., cols], kf[:, cols])
    return (dq.bfloat16(), dk.permute(0, 2, 1, 3).bfloat16(),
            dvv.permute(0, 2, 1, 3).bfloat16())


def _inputs(case, seed=0):
    """bf16 q, k, v, do (numpy draws), positions (q a suffix of k), and the
    training forward's bf16 output, float32 log-sum-exp and the output's
    bf16 rounding residual (last)."""
    b, sq, skv, kvh, G, dh, dv, window, cap, empty = case
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .bfloat16()
    q, k, v = draw(b, sq, kvh, G, dh), draw(b, skv, kvh, dh), \
        draw(b, skv, kvh, dv)
    do = draw(b, sq, kvh, G, dv)
    q_pos = torch.arange(skv - sq, skv, dtype=torch.int32)
    k_pos = torch.arange(skv, dtype=torch.int32)
    if empty:
        k_pos[skv // 2:] = SENTINEL
    out, lse, lo = ops.flash_attention(q, k, v, q_pos, k_pos, window, cap,
                                       return_lse=True)
    return q, k, v, q_pos, k_pos, window, cap, out, lse, do, lo


def _within_gate(name, got, want):
    """tests/test_torch_train_cuda.py's bf16 flash gate."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
    g, w = got.float(), want.float()
    tol = 1e-2 * float(w.abs().max()) + 2.0 ** -6 * w.abs()
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries off, max abs err "
        f"{float((g - w).abs().max())}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_emulation_within_the_gate(case):
    q, k, v, q_pos, k_pos, window, cap, out, lse, do, lo = _inputs(case)
    got = _bwd_bf16_emulation(q, k, v, q_pos, k_pos, window, cap, out, lse,
                              do, lo)
    want = ref.attention_bwd(q, k, v, q_pos, k_pos, window, cap, do)
    for name, g, w in zip(NAMES, got, want):
        assert not bool(torch.isnan(g.float()).any()), name
        _within_gate(name, g, w)
    if case[-1]:        # every empty slot's key and value take no gradient
        empty = k_pos == SENTINEL
        assert bool((got[1][:, empty] == 0).all())
        assert bool((got[2][:, empty] == 0).all())


def test_bf16_emulation_against_the_reference_vjp():
    """RecurrentGemma-9B's layout at 500 queries (one chunk of the core, not
    a multiple of the tile) against jax.vjp of attention_core in bf16."""
    case = (1, 500, 500, 1, 16, 256, 256, 200, None, False)
    q, k, v, q_pos, k_pos, window, cap, out, lse, do, lo = _inputs(case,
                                                                   seed=4)
    got = _bwd_bf16_emulation(q, k, v, q_pos, k_pos, window, cap, out, lse,
                              do, lo)

    def f(q_, k_, v_):
        return attention_core(q_, k_, v_, jnp.asarray(q_pos.numpy()),
                              jnp.asarray(k_pos.numpy()), window=window,
                              cap=cap)

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    _, vjp = jax.vjp(f, to_jax(q), to_jax(k), to_jax(v))
    want = [torch.from_numpy(np.array(g.astype(jnp.float32)))
            .bfloat16() for g in vjp(to_jax(do))]
    for name, g, w in zip(NAMES, got, want):
        _within_gate(name, g, w)


def _least_factor(got, want):
    """The least a with |got - want| <= a max|want| + 2^-6 |want|."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - 2.0 ** -6 * w.abs()).max()) / float(
        w.abs().max())


def _forward_bf16_emulation(q, k, v, pos):
    """The bfloat16 forward as the kernel computes it, causal: P = exp(s -
    max) rounded to bfloat16 as the operand of P V, float32 sums, the row
    sum from the float32 P.  Returns (out, out_lo): the output rounded to
    bfloat16 and its rounding residual, bf16(o - bf16(o))."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    s = torch.where(pos[None, :] <= pos[:, None], s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgqs,bskd->bqkgd", p.bfloat16().float(), v.float()) \
        / p.sum(-1, keepdim=True).permute(0, 3, 1, 2, 4)
    out = o.bfloat16()
    return out, (o - out.float()).bfloat16()


def test_output_residual_gives_d_float32_precision():
    """Near-uniform attention (small q) over values with a common mean of 8,
    24 heads of d 64, causal: D = dO . O is large and dP - D small, so D's
    2^-9 error from the bfloat16 output alone puts dq past the gate; the
    forward's residual, bf16(o - bf16(o)), gives back D from the forward's
    float32 output, within the gate and several times closer."""
    b, s, kvh, dh = 1, 256, 24, 64
    rng = np.random.default_rng(11)

    def draw(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=shape) * scale + shift)
                                .astype(np.float32)).bfloat16()
    q = draw(b, s, kvh, 1, dh, scale=0.01)
    k = draw(b, s, kvh, dh)
    v = draw(b, s, kvh, dh, shift=8.0)
    do = draw(b, s, kvh, 1, dh)
    pos = torch.arange(s, dtype=torch.int32)
    out, out_lo = _forward_bf16_emulation(q, k, v, pos)
    lse = ref.attention_lse(q, k, pos, pos, None, None)
    want = ref.attention_bwd(q, k, v, pos, pos, None, None, do)
    plain = _bwd_bf16_emulation(q, k, v, pos, pos, None, None, out, lse, do,
                                torch.zeros_like(out_lo))   # out alone
    fixed = _bwd_bf16_emulation(q, k, v, pos, pos, None, None, out, lse, do,
                                out_lo)
    assert _least_factor(plain[0], want[0]) > 1e-2          # dq off the gate
    for name, g, w in zip(NAMES, fixed, want):
        _within_gate(name, g, w)
    assert _least_factor(fixed[0], want[0]) < 0.5 * _least_factor(
        plain[0], want[0])


def test_slices_split_the_train_call():
    """At RecurrentGemma-9B's train call the G heads split in four (128
    key tiles, 512 dK / dV blocks: as many partials as dq's bytes hold); at
    Gemma2-9B's and DeepSeek's, where the kv heads give the grid its
    blocks, one slice;
    where dq's bytes cannot hold two slices' partials, or four blocks an
    SM are reached already, one slice."""
    assert _slices(2, 4096, 4096, 1, 16, 256, 256) == 4
    # Gemma2-9B's train calls (G 2) and DeepSeek's MLA (G 1): 2,048 blocks
    # cover the SMs, one slice
    assert _slices(2, 8192, 8192, 8, 2, 256, 256) == 1
    assert _slices(2, 4096, 4096, 16, 1, 192, 128) == 1
    assert _slices(1, 256, 256, 1, 1, 64, 64) == 1
    assert _slices(1, 64, 8192, 4, 4, 64, 64) == 1


def test_backward_takes_a_residual_only_of_out_s_shape_in_bfloat16():
    """``flash_attention_bwd``'s ``out_lo``: required in bfloat16, of out's
    shape and dtype, and refused in float32, with ``ValueError`` on either
    device.  The forward with ``return_lse`` gives it: on the CPU the
    float32 output's rounding residual, bf16(o - bf16(o)), as the kernel
    writes it, and the plain backward, which recomputes what out and out_lo
    hold."""
    case = (1, 40, 40, 2, 2, 16, 16, None, None, False)
    q, k, v, q_pos, k_pos, window, cap, out, lse, do, lo = _inputs(case,
                                                                   seed=3)
    o32 = ref.attention(q.float(), k.float(), v.float(), q_pos, k_pos)
    assert torch.equal(out, ref.attention(q, k, v, q_pos, k_pos))
    assert lo.dtype == torch.bfloat16 and bool(lo.any())
    assert torch.equal(lo, (o32 - out.float()).bfloat16())
    assert torch.equal(lse, ref.attention_lse(q, k, q_pos, k_pos))
    got = ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do,
                                  out_lo=lo)
    want = ref.attention_bwd(q, k, v, q_pos, k_pos, None, None, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (None, lo[:, 1:], lo.float()):
        with pytest.raises(ValueError, match="out_lo"):
            ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do,
                                    out_lo=bad)
    f = [t.float() for t in (q, k, v, out, do)]
    with pytest.raises(ValueError, match="out_lo"):
        ops.flash_attention_bwd(f[0], f[1], f[2], q_pos, k_pos, f[3], lse,
                                f[4], out_lo=lo)
