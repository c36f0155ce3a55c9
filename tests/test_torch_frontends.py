"""The two frontend architectures (Pixtral-12B, MusicGen-medium) of the port
against the JAX package's, on the CPU.

Their frontends are stubs in both packages: the caller's embeddings
``extra_emb`` (b, n_embeds, d) replace the first ``n_embeds`` positions of a
full sequence (``_frontend_override``), and decode ignores them.  The JAX
package draws the weights with ``jax.random.key(0)``; the port takes them
over (``convert.model_params_from_reference``), and both run the same
seeded ids and embeddings.

Tolerances are ``tests/test_torch_models.py``'s: float32 hidden states and
gradients to 1e-4 of their largest value, logits to 2e-3 absolute;
bfloat16 to 3e-2 of the largest value.  ``_frontend_override`` is held
bitwise, and so are the frontend draws of ``launch.train``.  Losses of
``train.run`` to ``tests/test_torch_train.py``'s rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core import policies as RP
from repro.core.sync import apply_and_sync as ref_apply_and_sync
from repro.launch import steps as RS
from repro.launch import train as ref_train
from repro.launch.state import init_train_state as ref_init_train_state
from repro.models import model as RM
from repro.models.common import ShardCtx as RefCtx
from repro.models.common import instantiate_tree as ref_instantiate
from repro import optim as RO
from repro_torch import convert
from repro_torch.configs import (ConsistencySpec, InputShape, TrainConfig,
                                 get_config, reduced_config)
from repro_torch.launch import steps, train
from repro_torch.models import model as M
from repro_torch.models.common import ShardCtx, tree_leaves, tree_map, \
    tree_paths

ARCHS = ["pixtral-12b", "musicgen-medium"]
DTYPES = ["float32", "bfloat16"]
S = 16                       # prompt length; the reduced configs' n_embeds is 8
LOSS_RTOL = 1e-5


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(ref_reduced_config(arch), dtype=dtype, **kw),
            dataclasses.replace(reduced_config(arch), dtype=dtype, **kw))


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(x):
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _close(ref, got, dtype, what, f32_atol=None):
    r, g = _np(ref), _t(got)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    scale = max(float(np.abs(r).max()), 1e-6)
    err = float(np.abs(r - g).max())
    if dtype == "float32":
        tol = f32_atol if f32_atol is not None else 1e-4 * scale
    else:
        tol = 3e-2 * scale
    assert err <= tol, (what, err, tol)


def _models(arch, dtype, seed=0):
    """(ref cfg, port cfg, ref params, port params loaded, port float32
    master tree): one draw of the JAX package's weights in both."""
    rcfg, cfg = _cfgs(arch, dtype)
    rp = ref_instantiate(RM.model_defs(rcfg, 1), jax.random.key(seed))
    master = convert.model_params_from_reference(
        jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, cfg, rp, M.load_params(cfg, master), master


def _inputs(cfg, s=S, rows=2, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, (rows, s)).astype(np.int32)
    extra = rng.normal(0, 0.02, (rows, cfg.frontend.n_embeds,
                                 cfg.d_model)).astype(np.float32)
    return ids, extra


# ---------------------------------------------------------------------------
# _frontend_override
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("emb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [3, 8, 21])
@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_override_is_the_references_bits(arch, s, dtype, emb_dtype):
    """Shorter than, equal to and longer than n_embeds (8); the embeddings
    cast to the stream's dtype, bitwise."""
    rcfg, cfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    e = rng.normal(size=(2, cfg.frontend.n_embeds, cfg.d_model)).astype(
        np.float32)
    rx = jnp.asarray(x, jnp.dtype(dtype))
    re = jnp.asarray(e, jnp.dtype(emb_dtype))
    pos = np.arange(s, dtype=np.int32)
    want = RM._frontend_override(rcfg, RefCtx(), rx, re, jnp.asarray(pos))
    got = M._frontend_override(
        cfg, torch.tensor(_np(rx)).to(getattr(torch, dtype)),
        torch.tensor(_np(re)).to(getattr(torch, emb_dtype)),
        torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_t(got), _np(want))
    n = min(s, cfg.frontend.n_embeds)
    np.testing.assert_array_equal(_t(got)[:, n:], _np(rx)[:, n:])
    # no embeddings, or no frontend: the stream as it is
    assert M._frontend_override(cfg, torch.ones(1, s, 4), None,
                                torch.from_numpy(pos)).eq(1).all()


# ---------------------------------------------------------------------------
# forward, prefill, lm_loss against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [S, 5])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch, dtype, s):
    """The full forward's hidden states, prefill's logits and caches, with
    the frontend's embeddings; at s 5 the prompt is shorter than
    n_embeds, and every position is replaced."""
    rcfg, cfg, rp, params, _ = _models(arch, dtype)
    ids, extra = _inputs(cfg, s)
    x_ref, _, _ = RM.forward(rcfg, RefCtx(), rp, jnp.asarray(ids),
                             extra_emb=jnp.asarray(extra), remat=False)
    lg_ref, c_ref = RM.prefill(rcfg, RefCtx(), rp, jnp.asarray(ids),
                               capacity=s + 4, extra_emb=jnp.asarray(extra))
    prefill_step = steps.make_prefill_step(
        cfg, None, InputShape("t", s + 4, 2, "prefill"))
    with torch.inference_mode():
        x, _, _ = M.forward(cfg, ShardCtx(), params, torch.from_numpy(ids),
                            extra_emb=torch.from_numpy(extra))
        lg, caches = M.prefill(cfg, ShardCtx(), params,
                               torch.from_numpy(ids), capacity=s + 4,
                               extra_emb=torch.from_numpy(extra))
    nxt, _ = prefill_step(params, {"ids": torch.from_numpy(ids),
                                   "extra_emb": torch.from_numpy(extra)})
    assert x.dtype == getattr(torch, dtype)
    _close(x_ref, x, dtype, "hidden")
    _close(lg_ref, lg, dtype, "prefill logits", f32_atol=2e-3)
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_leaves_with_path(c_ref)}
    got = _flat(caches)
    assert sorted(want) == sorted(got)
    for path, r in want.items():
        if np.asarray(r).dtype == np.int32:
            np.testing.assert_array_equal(got[path].numpy(), np.asarray(r))
        else:
            _close(r, got[path], dtype, f"cache {path}")
    if dtype == "float32":
        np.testing.assert_array_equal(
            nxt.numpy(), np.asarray(RM.sample_greedy(RefCtx(), lg_ref)))


def _flat(tree, path=""):
    """{path: tensor} of a port tree, paths as ``jax.tree_util.keystr``
    writes them."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}[{key!r}]").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}[{i}]").items()}
    return {path: tree}


def _ref_loss_grads(rcfg, rp, ids, labels, extra):
    def loss_fn(p):
        return RM.lm_loss(rcfg, RefCtx(), p, jnp.asarray(ids),
                          jnp.asarray(labels), remat=True, chunk=8,
                          extra_emb=jnp.asarray(extra))
    (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(rp)
    return loss, grads


def _port_loss_grads(cfg, master, ids, labels, extra):
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(master)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), master)
    loss, _ = M.lm_loss(cfg, ShardCtx(), p, torch.from_numpy(ids),
                        torch.from_numpy(labels).long(),
                        extra_emb=torch.from_numpy(extra), remat=True,
                        chunk=8)
    it = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(it), p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch, dtype):
    """The loss and every leaf's gradient (float32 master leaves), the
    embedding's rows at the replaced positions included: ids that occur
    only at replaced positions get an all-zero gradient row in both."""
    rcfg, cfg, rp, _, master = _models(arch, dtype)
    n = cfg.frontend.n_embeds
    ids, extra = _inputs(cfg, 32)
    # tokens 1..n fill the replaced positions and occur nowhere else
    ids[:, n:] = np.where(ids[:, n:] <= n, ids[:, n:] + n, ids[:, n:])
    ids[:, :n] = np.arange(1, n + 1)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -1
    r_loss, r_grads = _ref_loss_grads(rcfg, rp, ids, labels, extra)
    loss, grads = _port_loss_grads(cfg, master, ids, labels, extra)
    tol = LOSS_RTOL if dtype == "float32" else 3e-2
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=tol)
    want, got = tree_paths(jax.tree.map(np.asarray, r_grads)), \
        tree_paths(grads)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == torch.float32, k
        _close(want[k], got[k], dtype, f"grad {k}")
    rows = slice(1, n + 1)
    assert not np.any(want["embed"][rows])
    assert not bool(got["embed"][rows].any())
    assert bool(got["embed"][n + 1:].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_embeddings_change_the_output(arch):
    """``test_system.py::test_frontend_override_positions`` on the port:
    moving the first embedding moves the output."""
    _, cfg, _, params, _ = _models(arch, "float32")
    ids = torch.ones((1, S), dtype=torch.long)
    e1 = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, cfg.frontend.n_embeds, cfg.d_model)).astype(np.float32))
    e2 = e1.clone()
    e2[:, 0] += 1.0
    with torch.inference_mode():
        x0, _, _ = M.forward(cfg, ShardCtx(), params, ids)
        x1, _, _ = M.forward(cfg, ShardCtx(), params, ids, extra_emb=e1)
        x2, _, _ = M.forward(cfg, ShardCtx(), params, ids, extra_emb=e2)
    assert float((x1 - x2).abs().max()) > 1e-6
    assert float((x0 - x1).abs().max()) > 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_full_forward(arch):
    """``test_decode_parity.py`` on the port: prefill with the embeddings,
    then three decode steps, each against the full forward over the same
    ids and embeddings."""
    _, cfg, _, params, _ = _models(arch, "float32")
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S + 3)))
    extra = torch.from_numpy(rng.normal(
        size=(2, cfg.frontend.n_embeds, cfg.d_model)).astype(np.float32)
        * 0.01)
    ctx = ShardCtx()
    with torch.inference_mode():
        x, _, _ = M.forward(cfg, ctx, params, ids, extra_emb=extra)
        _, caches = M.prefill(cfg, ctx, params, ids[:, :S], capacity=S + 8,
                              extra_emb=extra)
        for j in range(3):
            pos = torch.full((2,), S + j, dtype=torch.int32)
            logits_d, caches = M.decode_step(cfg, ctx, params,
                                             ids[:, S + j:S + j + 1], pos,
                                             caches)
            gt = M.logits_of(cfg, params, x[:, S + j])
            err = float((logits_d - gt).abs().max())
            assert err < 2e-3, (arch, j, err)


def test_layernorm_bias_and_untied_head_carry_across():
    """``convert`` carries MusicGen's LayerNorm biases and Pixtral's untied
    head across bit for bit, and back."""
    _, _, rp, _, master = _models("musicgen-medium", "float32")
    want = tree_paths(jax.tree.map(np.asarray, rp))
    biases = [k for k in want if k.endswith("bias")]
    assert biases and "final_norm/bias" in biases
    got = tree_paths(master)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    _, _, rp, _, master = _models("pixtral-12b", "float32", seed=3)
    assert "head" in master and master["head"].shape == (128, 512)
    np.testing.assert_array_equal(master["head"].numpy(),
                                  np.asarray(rp["head"]))
    rcfg, _ = _cfgs("pixtral-12b", "float32")
    rt = RefTrainConfig(arch="pixtral-12b")
    rs = jax.tree.map(np.asarray, ref_init_train_state(
        rcfg, rt, tp=1, dp=1, key=jax.random.key(2)))
    back = convert.train_state_to_numpy(
        convert.train_state_from_reference(rs, "cpu"))
    np.testing.assert_array_equal(back["params"]["head"], rs.params["head"])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_frontend_draws_are_the_references_bits(dtype):
    """``train.frontend_draws``: numpy's normal(0, 0.02) draws, one a step
    after the seed, cast to the config's dtype as ``jnp.asarray`` casts
    them in the reference's ``run``."""
    _, cfg = _cfgs("pixtral-12b", dtype)
    draw = train.frontend_draws(cfg, 5, 3)
    rng = np.random.default_rng(5)
    for _ in range(3):
        want = jnp.asarray(rng.normal(0, 0.02, (3, 8, 128)), jnp.dtype(dtype))
        got = draw()
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_t(got), _np(want))
    assert train.frontend_draws(reduced_config("olmo-1b"), 5, 3) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_train_run_matches_the_references_run(arch, monkeypatch):
    """``launch.train.run`` against the reference's ``run`` from one
    initial state (the reference's, carried across): every step's batch
    the same bits, ``extra_emb`` included, and the losses within rtol
    1e-5 (SGD: an Adam trajectory turns ulp differences in near-zero
    gradients into lr-sized updates)."""
    rcfg, cfg = _cfgs(arch, "float32")
    kw = dict(arch=arch, steps=3, log_every=1, lr=1e-2, optimizer="sgd",
              warmup_steps=0, seed=4)
    rt, pt = RefTrainConfig(**kw), TrainConfig(**kw)
    seen = {"ref": [], "port": []}

    def recording(make, side):
        def factory(*a, **k):
            step = make(*a, **k)

            def call(state, batch):
                seen[side].append({k: _np(v) if side == "ref" else
                                   (v.numpy() if isinstance(v, torch.Tensor)
                                    else np.asarray(v))
                                   for k, v in batch.items()})
                return step(state, batch)
            return call
        return factory

    monkeypatch.setattr(RS, "make_train_step",
                        recording(RS.make_train_step, "ref"))
    monkeypatch.setattr(steps, "make_train_step",
                        recording(steps.make_train_step, "port"))
    ref_state = jax.tree.map(np.asarray, ref_init_train_state(
        rcfg, rt, tp=1, dp=1, key=jax.random.key(rt.seed)))
    monkeypatch.setattr(train, "init_train_state", lambda *a, **k:
                        convert.train_state_from_reference(ref_state, "cpu"))
    _, r_hist = ref_train.run(rt, rcfg, batch_size=4, seq_len=24,
                              log=lambda *_: None)
    _, p_hist = train.run(pt, cfg, batch_size=4, seq_len=24,
                          log=lambda *_: None, device="cpu")
    assert len(seen["ref"]) == len(seen["port"]) == 3
    for r, p in zip(seen["ref"], seen["port"]):
        assert set(r) == set(p) == {"ids", "labels", "extra_emb"}
        assert p["extra_emb"].shape == (4, cfg.frontend.n_embeds,
                                        cfg.d_model)
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    assert [h["step"] for h in p_hist] == [h["step"] for h in r_hist]
    for r, p in zip(r_hist, p_hist):
        np.testing.assert_allclose(p["loss"], r["loss"], rtol=LOSS_RTOL)
        assert p["synced"] == r["synced"]


@pytest.mark.parametrize("width, lr, falls", [
    ("full", 1e-3, False), ("full", 1e-5, True), ("reduced", 1e-3, True)])
def test_adam_at_full_width_rises_at_1e3_in_both(width, lr, falls,
                                                 monkeypatch):
    """Why the frontend train cells of ``chip_smoke.py`` take an lr below
    the other cells' 1e-3.  MusicGen-medium at its full width (d 1,536, 24
    heads of 64, d_ff 6,144, its 2,048-word vocabulary and 64 conditioning
    frames) at one layer, or at the reduced config's width (d 128), in
    float32: 2 x 128 tokens, 4 Adam steps under the cells' 2-step warm-up,
    remat and cvap(2, 1.8 lr), from the reference's initial state.  The
    reference's ``run`` and the port's ``train.run`` give the same losses
    (rtol 1e-5), and in both the last lies above the first at full width
    and lr 1e-3, below it at 1e-5, and below it at the reduced width at
    1e-3: Adam's first step moves every weight by that step's whole lr
    (m / sqrt(v) is +-1), in a direction that agrees across a row's d
    inputs, so the step's effect on a layer's output grows with the
    width.  The rise is the model's and the optimizer's, not the port's."""
    arch = "musicgen-medium"
    if width == "full":
        kw = dict(n_layers=1, dtype="float32")
        rcfg = dataclasses.replace(ref_get_config(arch), **kw)
        cfg = dataclasses.replace(get_config(arch), **kw)
    else:
        rcfg, cfg = _cfgs(arch, "float32")
    kw = dict(arch=arch, optimizer="adam", lr=lr, warmup_steps=2, steps=4,
              log_every=1, remat=True, seed=0)
    rt = RefTrainConfig(**kw, consistency=RP.ConsistencySpec(
        model="cvap", staleness=2, value_bound=1.8 * lr))
    pt = TrainConfig(**kw, consistency=ConsistencySpec(
        model="cvap", staleness=2, value_bound=1.8 * lr))
    ref_state = jax.tree.map(np.asarray, ref_init_train_state(
        rcfg, rt, tp=1, dp=1, key=jax.random.key(rt.seed)))
    monkeypatch.setattr(train, "init_train_state", lambda *a, **k:
                        convert.train_state_from_reference(ref_state, "cpu"))
    _, r_hist = ref_train.run(rt, rcfg, batch_size=2, seq_len=128,
                              log=lambda *_: None)
    _, p_hist = train.run(pt, cfg, batch_size=2, seq_len=128,
                          log=lambda *_: None, device="cpu")
    r_loss = [h["loss"] for h in r_hist]
    p_loss = [h["loss"] for h in p_hist]
    np.testing.assert_allclose(p_loss, r_loss, rtol=LOSS_RTOL)
    for losses in (r_loss, p_loss):
        assert (losses[-1] < losses[0]) == falls, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_two_replicas_split_the_embeddings_by_rows(arch):
    """Two stacked replicas, one bsp SGD step: each replica trains on its
    rows of ``extra_emb`` as of ``ids``, as the reference's step under
    ``jax.vmap(axis_name="data")`` does."""
    rcfg, cfg = _cfgs(arch, "float32")
    kw = dict(arch=arch, optimizer="sgd", lr=1e-2, warmup_steps=0)
    rt = RefTrainConfig(**kw)
    pt = TrainConfig(**kw, consistency=ConsistencySpec(model="bsp"))
    rs = ref_init_train_state(rcfg, rt, tp=1, dp=2, key=jax.random.key(6))
    ps = convert.train_state_from_reference(jax.tree.map(np.asarray, rs),
                                            "cpu")
    rows, seq = 2, 24
    ids, extra = _inputs(cfg, seq + 1, rows=2 * rows, seed=7)
    batch = {"ids": ids[:, :-1], "labels": ids[:, 1:], "extra_emb": extra}
    policy = RP.from_spec(rt.consistency)
    opt_fn = RO.optimizer_update(rt.optimizer)

    def local(state, ids, labels, extra):
        def loss_fn(p):
            return RM.lm_loss(rcfg, RefCtx(), p, ids, labels,
                              extra_emb=extra, remat=rt.remat)
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        upd, opt = opt_fn(grads, state.opt, rt.lr, params=state.params,
                          weight_decay=rt.weight_decay)
        params, sync, _ = ref_apply_and_sync(state.params, state.sync, upd,
                                             policy, ("data",))
        return dataclasses.replace(state, params=params, opt=opt, sync=sync,
                                   step=state.step + 1), loss

    rs, rloss = jax.jit(jax.vmap(local, axis_name="data"))(
        rs, *(jnp.asarray(batch[k]).reshape((2, rows) + batch[k].shape[1:])
              for k in ("ids", "labels", "extra_emb")))
    ps, pm = steps.make_train_step(cfg, pt)(ps, batch)
    np.testing.assert_allclose(float(pm["loss"]),
                               float(np.mean(np.asarray(rloss))),
                               rtol=LOSS_RTOL)
    want = tree_paths(jax.tree.map(np.asarray, rs.params))
    for k, p in tree_paths(ps.params).items():
        np.testing.assert_allclose(p.numpy(), want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
