"""The training path's kernels on the card (``cuda``-marked; they skip on a
host without one).  No JAX here: the kernel is held against its plain
version, ``ref.ssd_scan_bwd`` (autograd through ``ssd_chunked`` in
float32), run on the card on the same inputs.

Tolerance, per output: |kernel - plain| <= 1e-4 max|plain| + 1e-3 |plain|
(float32 sums in other orders over up to 256-step chunks), and where the
output is bfloat16 (dx, dB, dC of a bfloat16 call) 2^-6 |plain| for the
rounding of both to bfloat16 (two units in the last place).

Also: the scan's autograd ``Function`` on the card gives the plain
version's gradients and counts its launches; the backward is the same bits
run to run; the kernels that have no backward (flash attention, RG-LRU)
refuse a graph on the card and serve under ``no_grad``; the train step on
the card refuses RecurrentGemma.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, reduced_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as rg_ops
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


def _assert_close(name, got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    g, w = got.float(), want.float()
    tol = 1e-4 * float(w.abs().max()) + 1e-3 * w.abs()
    if got.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -6 * w.abs()
    bad = (g - w).abs() > tol
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries off, max abs err "
        f"{float((g - w).abs().max())}, max |plain| {float(w.abs().max())}")


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


def test_kernels_without_a_backward_refuse_a_graph(cuda):
    q = torch.randn(1, 64, 1, 2, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 1, 64, device=cuda)
    pos = torch.arange(64, device=cuda, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="6.1b"):
        flash_ops.flash_attention(q, k, k, pos, pos)
    with torch.no_grad():
        assert flash_ops.flash_attention(q, k, k, pos, pos).shape[1] == 64
    with torch.inference_mode():
        flash_ops.flash_attention(q, k, k, pos, pos)
    x = torch.randn(2, 16, 32, device=cuda, requires_grad=True)
    gate = torch.rand(2, 16, 32, device=cuda)
    a = torch.randn(32, device=cuda)
    with pytest.raises(NotImplementedError, match="6.1b"):
        rg_ops.rglru(x, gate, gate, a)
    with pytest.raises(NotImplementedError, match="6.1b"):
        rg_ops.linear_recurrence(gate, x)
    with torch.no_grad():
        rg_ops.rglru(x, gate, gate, a)


def test_recurrentgemma_training_is_refused_on_the_card(cuda):
    cfg = dataclasses.replace(reduced_config("recurrentgemma-9b"),
                              dtype="float32")
    tcfg = TrainConfig(arch="recurrentgemma-9b")
    state = init_train_state(cfg, tcfg, tp=1, dp=1, seed=0, device=cuda)
    step = steps.make_train_step(cfg, tcfg)
    batch = {"ids": torch.ones(2, 8, dtype=torch.int32),
             "labels": torch.ones(2, 8, dtype=torch.int32)}
    before = [t.clone() for t in state.sync.delta.values()]
    with pytest.raises(NotImplementedError, match="6.1b"):
        step(state, batch)
    assert all(torch.equal(a, b)
               for a, b in zip(before, state.sync.delta.values()))
    with pytest.raises(NotImplementedError, match="6.1b"):
        train.run(tcfg, cfg, batch_size=2, seq_len=8, device=cuda)
