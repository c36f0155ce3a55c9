"""The training path's kernels on the card (``cuda``-marked; they skip on a
host without one).  No JAX here: each backward kernel is held against its
plain version run on the card on the same inputs: ``ref.ssd_scan_bwd``
(autograd through ``ssd_chunked`` in float32), ``ref.rglru_bwd`` /
``ref.linear_recurrence_bwd`` (the forward's loop, then an explicit reverse
sweep in float32) and ``ref.attention_bwd`` (dense float32 formulas).

Tolerance, per output: |kernel - plain| <= 1e-4 max|plain| + 1e-3 |plain|
(float32 sums in other orders), and where the output is bfloat16 2^-6
|plain| more for the rounding of both to bfloat16 (two units in the last
place); the flash backward's bfloat16 entry 1e-2 max|plain| + 2^-6 |plain|
(it reads D = rowsum(dO O) from the forward's bfloat16 output, which the
plain version does not round; chip_smoke.py prints the least factor that
passes each case).

Also: each ``Function`` on the card gives the plain version's gradients and
counts its launches, and under ``no_grad`` the same forward without a
graph; each backward is the same bits run to run; the RG-LRU backward's dx,
dr, di and dinitial (and the bare recurrence's every output) are the plain
version's bits, with the forward's saved states and without; the forward
writes those states, bitwise ``ref.rglru_states``, only where a graph is
wanted; its kernels report no spill; the flash forward's
log-sum-exp against ``ref.attention_lse``; reduced RecurrentGemma trains on
the card through ``make_train_step`` and ``launch.train.run``; so do reduced
Gemma2-9B, DeepSeek-V2-Lite, Pixtral-12B and MusicGen-medium in bfloat16
(the last two with their frontends' embeddings), with the flash backward's
launches by window and the MoE's routes the same in remat's recomputation.
The two frontend models' attention layouts (Pixtral's G 4 at d 128,
MusicGen's 24 heads of G 1 at d 64) run the flash forward and backward at
reduced length against the plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.launch import steps, train
from repro_torch.launch.state import init_train_state

pytestmark = pytest.mark.cuda

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# (b, l, h, g, p, n, chunk, initial state, dfinal, column slices)
CASES = [
    (2, 32, 4, 1, 8, 6, 8, False, False, False),
    (2, 37, 4, 1, 8, 6, 8, False, True, False),
    (1, 30, 4, 2, 4, 5, 16, True, True, False),
    (2, 24, 4, 2, 8, 4, 8, True, False, True),
    (1, 5, 2, 1, 3, 4, 16, False, True, True),
    (1, 300, 4, 4, 64, 128, 256, True, True, False),   # the full tiles
    (1, 300, 24, 2, 64, 128, 256, True, True, True),   # 12 heads a group
    (1, 1000, 4, 1, 64, 128, 256, False, True, True),  # l % 64, l % cs != 0
    (2, 200, 4, 1, 32, 64, 128, True, False, False),   # p 32, n 64 tiles
    (2, 600, 24, 1, 64, 128, 256, False, False, True),  # Mamba2's layout
]
MAMBA2 = CASES[-1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(case, dtype, dev, seed=0):
    b, l, h, g, p, n, chunk, init, dfin, slices = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    if slices:
        xbc = r(b, l, h * p + 2 * g * n).to(dtype)
        x = xbc[..., :h * p].reshape(b, l, h, p)
        B = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
        C = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    else:
        x, B, C = (r(b, l, h, p).to(dtype), r(b, l, g, n).to(dtype),
                   r(b, l, g, n).to(dtype))
    dt = torch.nn.functional.softplus(r(b, l, h) - 1.0)
    A = -torch.exp(r(h) * 0.5)
    s0 = r(b, h, p, n) if init else None
    dy = r(b, l, h, p).to(dtype)
    df = r(b, h, p, n) if dfin else None
    return x, dt, A, B, C, chunk, s0, dy, df


def _assert_close(name, got, want, flash=False):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    if flash and got.dtype == torch.bfloat16:
        tol = 1e-2 * top + 2.0 ** -6 * w.abs()
    else:
        tol = 1e-4 * top + 1e-3 * w.abs()
        if got.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -6 * w.abs()
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries off, max abs err "
        f"{float((g - w).abs().max())}, max |plain| {top}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_backward_kernel_matches_plain(case, dtype, cuda):
    args = _inputs(case, dtype, cuda)
    before = ops.bwd_launches
    got = ops.ssd_scan_bwd(*args)
    assert ops.bwd_launches == before + 1
    want = ref.ssd_scan_bwd(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None
            continue
        assert g.is_cuda
        _assert_close(name, g, w)


def test_backward_kernel_is_the_same_run_to_run(cuda):
    args = _inputs(MAMBA2, torch.bfloat16, cuda, seed=2)
    first = ops.ssd_scan_bwd(*args)
    second = ops.ssd_scan_bwd(*args)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_autograd_through_the_scan_on_the_card(dtype, cuda):
    # padding, g = 2, an initial state and dfinal
    x, dt, A, B, C, chunk, s0, dy, df = _inputs(CASES[2], dtype, cuda, 5)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, B, C, s0)]
    f0, b0 = ops.launches, ops.bwd_launches
    y, fin = ops.ssd_scan(*leaves[:5], chunk, initial_state=leaves[5])
    assert y.grad_fn is not None and fin.grad_fn is not None
    got = torch.autograd.grad([y, fin], leaves, [dy, df])
    assert (ops.launches, ops.bwd_launches) == (f0 + 1, b0 + 1)
    want = ref.ssd_scan_bwd(x, dt, A, B, C, chunk, s0, dy, df)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w)
    # only y used: dfinal is None to the kernel
    y, _ = ops.ssd_scan(*leaves[:5], chunk, initial_state=leaves[5])
    got = torch.autograd.grad((y.float() * dy.float()).sum(), leaves)
    want = ref.ssd_scan_bwd(x, dt, A, B, C, chunk, s0, dy, None)
    for name, g, w in zip(NAMES, got, want):
        _assert_close(name, g, w)
    # no gradient wanted: the same launches without a graph
    with_graph = ops.ssd_scan(*leaves[:5], chunk, initial_state=leaves[5])
    with torch.no_grad():
        plain = ops.ssd_scan(*leaves[:5], chunk, initial_state=leaves[5])
    assert all(t.grad_fn is None for t in plain)
    assert all(torch.equal(a.detach(), b)
               for a, b in zip(with_graph, plain))


RG_NAMES = ("dx", "dr", "di", "da_param", "dinitial")
# (b, l, w, initial state, dh_last, sqrt clamp's region): chunked and
# partial chunks, w not a multiple of 8, one step, the clamp, w 4,096
RG_CASES = [(2, 64, 128, True, True, False), (1, 100, 50, True, False, False),
            (3, 1, 40, False, True, False), (2, 37, 256, True, True, True),
            (1, 333, 4096, False, False, False)]


def _rg_inputs(case, dtype, dev, seed=0):
    b, l, w, init, last, clamp = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo
    rg, lam = u(0, 1, b, l, w), r(w)
    if clamp:                     # 1 - a² at and below the 1e-12 clamp
        rg, lam = u(0, 1e-3, b, l, w), torch.full((w,), -30.0, device=dev)
    return (r(b, l, w).to(dtype), rg.to(dtype), u(0, 1, b, l, w).to(dtype),
            lam.to(dtype), r(b, w) if init else None, r(b, l, w).to(dtype),
            r(b, w) if last else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RG_CASES, ids=lambda c: "-".join(map(str, c)))
def test_rglru_backward_kernel_matches_plain(case, dtype, cuda):
    args = _rg_inputs(case, dtype, cuda)
    before = dict(rg_ops.bwd_launches_by_entry)
    got = rg_ops.rglru_bwd(*args)
    entry = rg_ops.RGLRU_BWD_ENTRIES[dtype]
    assert rg_ops.bwd_launches_by_entry[entry] == before[entry] + 1
    want = rg_ref.rglru_bwd(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(RG_NAMES, got, want):
        if w is None:
            assert g is None
            continue
        assert g.is_cuda
        _assert_close(name, g, w)
    again = rg_ops.rglru_bwd(*args)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RG_CASES, ids=lambda c: "-".join(map(str, c)))
def test_rglru_backward_kernel_is_the_plain_bits(case, dtype, cuda):
    """dx, dr, di and dinitial are the plain version's bits on the card
    (the same per-element operations, g's chain in the same order), with
    the forward's states and without them (the wrapper then runs the
    forward's launch first); only dΛ is summed in the kernel's own order.
    l off the 32-step chunk (100, 37, 333, 1) and the sqrt clamp's region
    are among the cases."""
    args = _rg_inputs(case, dtype, cuda, seed=11)
    _, _, states = rg_ops.rglru_with_states(*args[:5])
    got = rg_ops.rglru_bwd(*args, states=states)
    want = rg_ref.rglru_bwd(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(RG_NAMES, got, want):
        if w is None:
            assert g is None
        elif name == "da_param":
            _assert_close(name, g, w)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    without = rg_ops.rglru_bwd(*args)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(got, without))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [RG_CASES[1], RG_CASES[3], RG_CASES[4]],
                         ids=lambda c: "-".join(map(str, c)))
def test_rglru_forward_writes_the_plain_states(case, dtype, cuda):
    """With a graph wanted the forward's launch also writes the state
    entering every chunk, saved for the backward: bitwise the plain
    helper's on the card.  Without a graph (serving) it writes none, and h
    and h_last keep their bits."""
    x, r, i, lam, s0, dh, dl = _rg_inputs(case, dtype, cuda, seed=12)
    leaves = [t.clone().requires_grad_(True) for t in (x, r, i, lam)]
    f0 = rg_ops.launches
    h, h_last = rg_ops.rglru(*leaves, s0)
    assert rg_ops.launches == f0 + 1
    states = h.grad_fn.saved_tensors[-1]
    assert states.dtype == torch.float32 and states.shape == (
        x.shape[0], -(-x.shape[1] // rg_ops.CHUNK), x.shape[2])
    assert torch.equal(states, rg_ref.rglru_states(x, r, i, lam, s0))
    with torch.no_grad():
        serve = rg_ops.rglru(x, r, i, lam, s0)
    want = rg_ref.rglru(x, r, i, lam, s0)
    for a, b, c in zip(serve, (h.detach(), h_last.detach()), want):
        assert torch.equal(a, b) and torch.equal(a, c)
    a = torch.rand(x.shape, device=cuda, requires_grad=True)
    hh, _ = rg_ops.linear_recurrence(a, r.float(), s0)
    assert torch.equal(hh.grad_fn.saved_tensors[-1],
                       rg_ref.linear_recurrence_states(a.detach(), r.float(),
                                                       s0))


def test_rglru_backward_kernels_do_not_spill(cuda):
    attrs = rg_ops.bwd_attrs(cuda)
    assert set(attrs) == set(rg_ops.BWD_KERNELS)
    for name, a in attrs.items():
        assert a["local_bytes"] == 0, (name, a)
        assert 0 < a["registers"] <= 255 and a["blocks_per_sm"] >= 1, (name, a)
        assert a["static_smem_bytes"] + a["dynamic_smem_bytes"] <= 232448


@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 33, 50), (3, 1, 8)])
def test_linear_recurrence_backward_kernel_matches_plain(shape, cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, l, w = shape
    a = torch.rand(shape, generator=gen, device=cuda) * 0.3 + 0.69
    bb, dh = (torch.randn(shape, generator=gen, device=cuda)
              for _ in range(2))
    s0, dl = (torch.randn(b, w, generator=gen, device=cuda)
              for _ in range(2))
    before = rg_ops.bwd_launches
    got = rg_ops.linear_recurrence_bwd(a, bb, s0, dh, dl)
    assert rg_ops.bwd_launches == before + 1
    want = rg_ref.linear_recurrence_bwd(a, bb, s0, dh, dl)
    for name, g, w_ in zip(("da", "db", "dinitial"), got, want):
        _assert_close(name, g, w_)
        assert torch.equal(g, w_), name
    assert all(torch.equal(x, y) for x, y in zip(
        got, rg_ops.linear_recurrence_bwd(a, bb, s0, dh, dl)))


# (b, sq, skv, kvh, G, dh, dv, window, cap, empty key slots): chip_smoke's
# stress cases, the last three the layouts of Gemma2-9B's train calls (8 kv
# heads, G 2, d 256, softcap 50; windowed below one tile, and global) and
# DeepSeek-V2-Lite's MLA (16 kv heads, G 1, q / k 192, v 128, causal)
FLASH_CASES = [(2, 256, 256, 2, 2, 64, 64, None, None, False),
               (1, 300, 300, 1, 4, 32, 32, None, 50.0, False),
               (1, 128, 128, 4, 1, 192, 128, None, None, False),
               (1, 512, 512, 1, 1, 128, 128, 64, 30.0, False),
               (1, 200, 333, 1, 4, 128, 64, 100, None, True),
               (2, 130, 130, 1, 2, 48, 80, 50, None, False),
               (1, 700, 700, 1, 16, 256, 256, 40, None, False),
               (1, 600, 600, 8, 2, 256, 256, 40, 50.0, False),
               (1, 600, 600, 8, 2, 256, 256, None, 50.0, False),
               (2, 512, 512, 16, 1, 192, 128, None, None, False)]


def _flash_inputs(case, dtype, dev, seed=0):
    b, sq, skv, kvh, G, dh, dv, window, cap, empty = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    q_pos = torch.arange(skv - sq, skv, dtype=torch.int32, device=dev)
    k_pos = torch.arange(skv, dtype=torch.int32, device=dev)
    if empty:
        k_pos[skv // 2:] = 2**30
    return (r(b, sq, kvh, G, dh), r(b, skv, kvh, dh), r(b, skv, kvh, dv),
            q_pos, k_pos, r(b, sq, kvh, G, dv), window, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_kernel_matches_plain(case, dtype, cuda):
    q, k, v, q_pos, k_pos, do, window, cap = _flash_inputs(case, dtype, cuda)
    out, lse, lo = flash_ops.flash_attention(q, k, v, q_pos, k_pos, window,
                                             cap, return_lse=True)
    assert (lo is None) == (dtype == torch.float32)
    want_lse = flash_ref.attention_lse(q, k, q_pos, k_pos, window, cap)
    seen = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), seen)
    assert torch.allclose(lse[seen], want_lse[seen], rtol=1e-5, atol=1e-5)
    before = flash_ops.bwd_launches
    got = flash_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do,
                                        window, cap, lo)
    assert flash_ops.bwd_launches == before + 1
    want = flash_ref.attention_bwd(q, k, v, q_pos, k_pos, window, cap, do)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert not bool(torch.isnan(g).any()), name
        _assert_close(name, g, w, flash=True)
    again = flash_ops.flash_attention_bwd(q, k, v, q_pos, k_pos, out, lse, do,
                                          window, cap, lo)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_autograd_through_rglru_on_the_card(dtype, cuda):
    x, r, i, lam, s0, dh, dl = _rg_inputs(RG_CASES[0], dtype, cuda, 5)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, r, i, lam, s0)]
    f0, b0 = rg_ops.launches, rg_ops.bwd_launches
    h, h_last = rg_ops.rglru(*leaves)
    assert h.grad_fn is not None and h_last.grad_fn is not None
    got = torch.autograd.grad([h, h_last], leaves, [dh, dl])
    assert (rg_ops.launches, rg_ops.bwd_launches) == (f0 + 1, b0 + 1)
    want = rg_ref.rglru_bwd(x, r, i, lam, s0, dh, dl)
    for name, g, w in zip(RG_NAMES, got, want):
        _assert_close(name, g, w)
    # no gradient wanted: the same launch without a graph
    with torch.no_grad():
        plain = rg_ops.rglru(*leaves)
    assert all(t.grad_fn is None for t in plain)
    assert torch.equal(plain[0], h.detach())
    # the bare recurrence's Function
    a = torch.rand(2, 30, 64, device=cuda, requires_grad=True)
    b = torch.randn(2, 30, 64, device=cuda, requires_grad=True)
    hh, _ = rg_ops.linear_recurrence(a, b)
    got = torch.autograd.grad(hh.sum(), [a, b])
    want = rg_ref.linear_recurrence_bwd(a.detach(), b.detach(), None,
                                        torch.ones_like(hh))
    for g, w in zip(got, want):
        _assert_close("linear_recurrence", g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_autograd_through_flash_on_the_card(dtype, cuda):
    q, k, v, q_pos, k_pos, do, window, cap = _flash_inputs(FLASH_CASES[4],
                                                           dtype, cuda, 5)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash_ops.launches, flash_ops.bwd_launches
    out = flash_ops.flash_attention(*leaves, q_pos, k_pos, window, cap)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert (flash_ops.launches, flash_ops.bwd_launches) == (f0 + 1, b0 + 1)
    want = flash_ref.attention_bwd(q, k, v, q_pos, k_pos, window, cap, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(name, g, w, flash=True)
    # serving: no_grad / inference_mode launch the forward alone
    with torch.no_grad():
        plain = flash_ops.flash_attention(*leaves, q_pos, k_pos, window, cap)
    with torch.inference_mode():
        flash_ops.flash_attention(*leaves, q_pos, k_pos, window, cap)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_recurrentgemma_trains_on_the_card(cuda):
    """Reduced RecurrentGemma in float32 through ``make_train_step`` and
    ``launch.train.run`` on the card: the RG-LRU and flash backward kernels
    launch, and the loss falls."""
    cfg = dataclasses.replace(reduced_config("recurrentgemma-9b"),
                              dtype="float32")
    tcfg = TrainConfig(arch="recurrentgemma-9b", lr=1e-3, warmup_steps=0)
    state = init_train_state(cfg, tcfg, tp=1, dp=1, seed=0, device=cuda)
    step = steps.make_train_step(cfg, tcfg)
    gen = np.random.default_rng(0)
    ids = gen.integers(1, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"ids": ids[:, :-1], "labels": ids[:, 1:]}
    rg0, fa0 = rg_ops.bwd_launches, flash_ops.bwd_launches
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert rg_ops.bwd_launches - rg0 == 3 * 2
    assert flash_ops.bwd_launches - fa0 == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    _, hist = train.run(dataclasses.replace(tcfg, steps=2), cfg,
                        batch_size=2, seq_len=16, device=cuda, log=str)
    assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-v2-lite-16b",
                                  "pixtral-12b", "musicgen-medium"])
def test_dense_and_mla_models_train_on_the_card(arch, cuda):
    """Reduced Gemma2 (local / global windows, softcaps) and DeepSeek (MLA,
    a dense first layer, MoE) in bfloat16 through ``make_train_step`` on
    the card, with chip_smoke.py's own accounting: the flash kernels launch
    as ``M.group_layers`` implies (``train_launches_per_step``: a unit's
    forward twice under remat, a layer outside the units once, the backward
    once a layer, by window), remat's recomputation routes every MoE pair
    as the forward did (``moe_routes``, ``moe_step_routes``), and the loss
    falls."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke

    cfg = reduced_config(arch)                      # bfloat16 compute
    tcfg = TrainConfig(arch=arch, lr=1e-3, warmup_steps=0)
    state = init_train_state(cfg, tcfg, tp=1, dp=1, seed=0, device=cuda)
    step = steps.make_train_step(cfg, tcfg)
    gen = np.random.default_rng(0)
    ids = gen.integers(1, cfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"ids": ids[:, :-1], "labels": ids[:, 1:],
             **chip_smoke.frontend_embeddings(cfg, gen, 2, cuda)}
    want, by_window = chip_smoke.train_launches_per_step(cfg, tcfg.remat)
    windows = []
    orig_bwd = flash_ops.flash_attention_bwd

    def bwd(*args):
        windows.append(args[8])
        return orig_bwd(*args)

    f0, b0 = flash_ops.launches, flash_ops.bwd_launches
    losses = []
    flash_ops.flash_attention_bwd = bwd
    try:
        for _ in range(3):
            with chip_smoke.moe_routes() as routes:
                state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if cfg.moe is not None:
                assert chip_smoke.moe_step_routes(routes, cfg,
                                                  tcfg.remat)[1] == 0
    finally:
        flash_ops.flash_attention_bwd = orig_bwd
    assert flash_ops.launches - f0 == 3 * want["flash_attention"]
    assert flash_ops.bwd_launches - b0 == 3 * want["flash_attention_bwd"]
    assert {w: windows.count(w) for w in set(windows)} == {
        w: 3 * n for w, n in by_window.items()}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# (b, sq, kvh, G, dh): the frontend models' attention at reduced length:
# Pixtral-12B's 8 kv heads of G 4 at d 128, MusicGen-medium's 24 heads of
# G 1 at d 64 (the kernels' 128 and 64 tiers), causal
FRONTEND_FLASH = [(2, 384, 8, 4, 128), (2, 384, 24, 1, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", FRONTEND_FLASH,
                         ids=lambda c: "-".join(map(str, c)))
def test_frontend_flash_layouts_forward_and_backward(layout, dtype, cuda):
    """The forward against ``ref.attention`` (``tests/test_kernels.py``'s
    tolerance: 2e-2 in bfloat16, 5e-5 + 1e-4 rel in float32), its
    log-sum-exp against ``ref.attention_lse``, and the backward through the
    autograd ``Function`` against ``ref.attention_bwd``, one launch each."""
    b, s, kvh, G, dh = layout
    case = (b, s, s, kvh, G, dh, dh, None, None, False)
    q, k, v, q_pos, k_pos, do, _, _ = _flash_inputs(case, dtype, cuda, 9)
    f0, b0 = flash_ops.launches, flash_ops.bwd_launches
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_ops.flash_attention(*leaves, q_pos, k_pos)
    got = torch.autograd.grad(out, leaves, do)
    assert (flash_ops.launches, flash_ops.bwd_launches) == (f0 + 1, b0 + 1)
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
           else dict(atol=5e-5, rtol=1e-4))
    want_out = flash_ref.attention(q, k, v, q_pos, k_pos)
    torch.testing.assert_close(out.detach().float(), want_out.float(), **tol)
    if dtype == torch.bfloat16:
        # the training forward's residual: out + out_lo nearer the float32
        # plain output than out alone, out itself the serve forward's bits
        o2, _, lo = flash_ops.flash_attention(q, k, v, q_pos, k_pos,
                                              return_lse=True)
        assert torch.equal(o2, out.detach())
        o32 = flash_ref.attention(q.float(), k.float(), v.float(), q_pos,
                                  k_pos)
        assert float((o2.float() + lo.float() - o32).abs().max()) \
            < float((o2.float() - o32).abs().max())
    _, lse, _ = flash_ops.flash_attention(q, k, v, q_pos, k_pos,
                                          return_lse=True)
    torch.testing.assert_close(lse, flash_ref.attention_lse(
        q, k, q_pos, k_pos, None, None), rtol=1e-5, atol=1e-5)
    want = flash_ref.attention_bwd(q, k, v, q_pos, k_pos, None, None, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert not bool(torch.isnan(g).any()), name
        _assert_close(name, g, w, flash=True)


def test_output_residual_keeps_the_backward_within_the_gate(cuda):
    """``tests/test_torch_flash_bwd_bf16.py``'s near-cancelling case on the
    card (near-uniform attention over values with a common mean of 8, 24
    heads of d 64, causal): the training forward's residual out_lo is at
    most half a bfloat16 ulp of out and brings out + out_lo closer to the
    plain float32 output (the kernel rounds P for P V, so not to float32's
    rounding), and the backward that takes it meets the gate; from the
    bfloat16 output alone D's error puts dq past it.  The inputs are that
    test's, whose emulation of the kernels' arithmetic puts dq at 1.8e-2 of
    max|plain| without the residual and 6.2e-3 with it."""
    b, s, kvh, dh = 1, 256, 24, 64
    rng = np.random.default_rng(11)

    def r(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=shape) * scale + shift)
                                .astype(np.float32)).to(cuda, torch.bfloat16)
    q = r(b, s, kvh, 1, dh, scale=0.01)
    k = r(b, s, kvh, dh)
    v = r(b, s, kvh, dh, shift=8.0)
    do = r(b, s, kvh, 1, dh)
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    out, lse, lo = flash_ops.flash_attention(q, k, v, pos, pos,
                                             return_lse=True)
    want_out = flash_ref.attention(q.float(), k.float(), v.float(), pos, pos)
    err_hi = float((out.float() - want_out).abs().max())
    err_lo = float((out.float() + lo.float() - want_out).abs().max())
    assert err_lo < 0.5 * err_hi, (err_lo, err_hi)
    assert bool((lo.float().abs() <= 2.0 ** -8 * out.float().abs()).all())
    assert bool(lo.any())
    want = flash_ref.attention_bwd(q, k, v, pos, pos, None, None, do)
    got = flash_ops.flash_attention_bwd(q, k, v, pos, pos, out, lse, do,
                                        out_lo=lo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(name, g, w, flash=True)
    # a residual of zeros: D from the bfloat16 output alone
    plain = flash_ops.flash_attention_bwd(q, k, v, pos, pos, out, lse, do,
                                          out_lo=torch.zeros_like(lo))
    with pytest.raises(AssertionError, match="dq"):
        _assert_close("dq", plain[0], want[0], flash=True)
