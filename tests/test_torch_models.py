"""The port's serving path against the JAX package's, on the CPU.

For the ten architectures at their reduced (smoke) sizes, for
RecurrentGemma with a tail block (5 layers: one rec/rec/attn unit plus two
rec layers whose 1-D leaves stay float32 and promote the residual), and
for OLMoE with one shared expert and a dense first layer (3 layers: the
dense prefix block and two MoE units), the JAX package's parameters are drawn with ``jax.random.key(0)``, carried
across as numpy (``convert.model_params_from_reference``), and both
packages run the same seeded token ids (and, for the two frontend
architectures, the same seeded frontend embeddings): ``forward`` hidden states,
``prefill`` logits and caches, three ``decode_step``s and the greedy tokens,
in float32 and in bfloat16, dtypes held equal at every output.

Tolerances.  float32: logits to 2e-3 absolute, as ``test_decode_parity.py``
holds decode against the full forward; hidden states and caches to 1e-4
relative to their largest value.  bfloat16: the two packages round at other
places (XLA on the CPU keeps bfloat16 intermediates in float32 inside a
fusion, torch rounds after every op), so values are held to 3e-2 of the
largest value (a few bfloat16 ulps carried through the layers), and the
greedy tokens must be equal (for the two frontend architectures, but at a
one-ulp tie in both packages' logits).

The last tests mirror ``test_decode_parity.py`` on the port alone: decode
after prefill reproduces the teacher-forced full forward, and decoding far
past the window keeps the ring cache right.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as RM
from repro.models.common import ShardCtx as RefCtx
from repro.models.common import instantiate_tree as ref_instantiate
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.common import ShardCtx, tree_map
from repro_torch.configs import InputShape

S = 16          # prompt length
N_DECODE = 3
ARCHS = ["recurrentgemma-9b", "recurrentgemma-9b-tail", "mamba2-130m",
         "olmo-1b", "qwen3-8b", "gemma2-2b", "gemma2-9b", "olmoe-1b-7b",
         "olmoe-1b-7b-shared", "deepseek-v2-lite-16b", "pixtral-12b",
         "musicgen-medium"]
DTYPES = ["float32", "bfloat16"]
# whose bfloat16 greedy tokens may differ from the reference's at a
# one-ulp tie (test_greedy_tokens_match_reference; reduced Pixtral's third
# decode step has one); the others' must match
TIE_ARCHS = {"pixtral-12b"}


def _variant(cfg, arch):
    """The test's variants of a reduced config, the same replace in both
    packages: RecurrentGemma with its tail, OLMoE with a shared expert and
    a dense first layer."""
    if arch.endswith("-tail"):
        return {"n_layers": 5}
    if arch.endswith("-shared"):
        return {"n_layers": 3, "moe": dataclasses.replace(
            cfg.moe, n_shared_experts=1, d_shared=64, first_dense_layers=1,
            d_ff_dense=128)}
    return {}


def _cfgs(arch, dtype):
    """(reference config, port config): the same values in both packages."""
    base = arch.replace("-tail", "").replace("-shared", "")
    ref, port = ref_reduced_config(base), reduced_config(base)
    return (dataclasses.replace(ref, dtype=dtype, **_variant(ref, arch)),
            dataclasses.replace(port, dtype=dtype, **_variant(port, arch)))


def _np(a):
    """A JAX array as float32/int numpy (bfloat16 widened exactly)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _dtname(x):
    return str(x.dtype).replace("torch.", "")


def _flat_ref(tree):
    """{path: leaf} of a JAX tree, paths as ``jax.tree_util.keystr``."""
    return {jax.tree_util.keystr(p): a
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _flat_ref_defs(defs, leaf_type):
    return {jax.tree_util.keystr(p): d
            for p, d in jax.tree_util.tree_leaves_with_path(
                defs, is_leaf=lambda x: isinstance(x, leaf_type))}


def _flat(tree, path=""):
    """{path: tensor} of a port tree, in the same path format."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}[{key!r}]").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}[{i}]").items()}
    return {path: tree}


def _close_caches(c_ref, c, dtype):
    ref, got = _flat_ref(c_ref), _flat(c)
    assert sorted(ref) == sorted(got)
    for path, r in ref.items():
        g = got[path]
        if np.asarray(r).dtype == np.int32:          # ring positions: exact
            assert g.dtype == torch.int32, path
            np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(r))
        else:
            _close(r, g, dtype, f"cache {path}")


@functools.lru_cache(maxsize=None)
def _run(arch, dtype, device="cpu"):
    """Both packages over the same weights and ids, the port on
    ``device``; returns a dict of (reference, port) pairs."""
    rcfg, cfg = _cfgs(arch, dtype)
    ref_params = ref_instantiate(RM.model_defs(rcfg, 1), jax.random.key(0))
    np_params = jax.tree.map(np.asarray, ref_params)
    params = M.load_params(cfg, convert.model_params_from_reference(
        np_params, device))
    rng = np.random.default_rng(1)
    ids = rng.integers(1, cfg.vocab_size, (2, S + N_DECODE)).astype(np.int32)
    # a frontend's embeddings replace the first n_embeds positions
    extra = (rng.normal(0, 0.02, (2, cfg.frontend.n_embeds, cfg.d_model))
             .astype(np.float32) if cfg.frontend is not None else None)

    def dev(a):
        return torch.from_numpy(a).to(device)

    rextra = None if extra is None else jnp.asarray(extra)
    pextra = {} if extra is None else {"extra_emb": dev(extra)}
    rctx, ctx = RefCtx(), ShardCtx()
    out = {}

    x_ref, _, _ = RM.forward(rcfg, rctx, ref_params, jnp.asarray(ids),
                             extra_emb=rextra, remat=False)
    with torch.inference_mode():
        x, _, _ = M.forward(cfg, ctx, params, dev(ids), **pextra)
    out["hidden"] = (x_ref, x)

    lg_ref, c_ref = RM.prefill(rcfg, rctx, ref_params,
                               jnp.asarray(ids[:, :S]), capacity=S + 8,
                               extra_emb=rextra)
    prefill_step = steps.make_prefill_step(
        cfg, None, InputShape("t", S + 8, 2, "prefill"))
    with torch.inference_mode():
        lg, caches = M.prefill(cfg, ctx, params, dev(ids[:, :S]),
                               capacity=S + 8, **pextra)
    nxt, caches_step = prefill_step(params, {"ids": dev(ids[:, :S]),
                                             **pextra})
    out["prefill_logits"] = (lg_ref, lg)
    out["prefill_caches"] = (c_ref, tree_map(lambda t: t.clone(), caches))
    out["greedy"] = [(RM.sample_greedy(rctx, lg_ref), nxt)]

    serve_step = steps.make_serve_step(
        cfg, None, InputShape("t", S + 8, 2, "decode"))
    dec = []
    for j in range(N_DECODE):
        pos = np.full((2,), S + j, np.int32)
        tok = ids[:, S + j:S + j + 1]
        lr, c_ref = RM.decode_step(rcfg, rctx, ref_params, jnp.asarray(tok),
                                   jnp.asarray(pos), c_ref)
        with torch.inference_mode():
            lp, caches = M.decode_step(cfg, ctx, params, dev(tok),
                                       dev(pos), caches)
        nxt, caches_step = serve_step(params, caches_step, {
            "ids": dev(tok), "pos": dev(pos)})
        dec.append((lr, lp))
        out["greedy"].append((RM.sample_greedy(rctx, lr), nxt))
    out["decode_logits"] = dec
    out["decode_caches"] = (c_ref, caches, caches_step)
    return out


def _close(ref, got, dtype, what, f32_atol=None):
    assert _dtname(got) == str(np.asarray(ref).dtype), (
        what, _dtname(got), np.asarray(ref).dtype)
    r, g = _np(ref), _t(got)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    scale = max(float(np.abs(r).max()), 1e-6)
    err = float(np.abs(r - g).max())
    if dtype == "float32":
        tol = f32_atol if f32_atol is not None else 1e-4 * scale
    else:
        tol = 3e-2 * scale
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch, dtype):
    ref, got = _run(arch, dtype)["hidden"]
    _close(ref, got, dtype, "hidden")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch, dtype):
    out = _run(arch, dtype)
    ref, got = out["prefill_logits"]
    _close(ref, got, dtype, "prefill logits", f32_atol=2e-3)
    _close_caches(*out["prefill_caches"], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_decode_steps_match_reference(arch, dtype):
    out = _run(arch, dtype)
    for j, (ref, got) in enumerate(out["decode_logits"]):
        _close(ref, got, dtype, f"decode {j}", f32_atol=2e-3)
    c_ref, c, c_step = out["decode_caches"]
    _close_caches(c_ref, c, dtype)
    # the serve step's in-place caches are the functional path's, bitwise
    for path, g in _flat(c).items():
        torch.testing.assert_close(_flat(c_step)[path], g, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch, dtype):
    """Equal tokens.  Only for reduced Pixtral in bfloat16 (``TIE_ARCHS``)
    may a request's tokens differ, and only at a one-ulp tie: where, in
    each package's own logits, the two tokens lie within one bfloat16 ulp
    of each other, rounding alone picks (its third decode step: the
    reference's 2.65625 / 2.640625, the port's 2.65625 / 2.65625)."""
    out = _run(arch, dtype)
    logits = [out["prefill_logits"]] + out["decode_logits"]
    for (ref, got), (lr, lp) in zip(out["greedy"], logits):
        assert got.dtype == torch.int32
        ref, got = np.asarray(ref), got.cpu().numpy()
        if dtype == "float32" or arch not in TIE_ARCHS:
            np.testing.assert_array_equal(got, ref)
            continue
        lr, lp = _np(lr), _t(lp)
        for row in np.flatnonzero(ref != got):
            pair = [ref[row], got[row]]
            for lg in (lr[row], lp[row]):
                a, b = lg[pair]
                ulp = 2.0 ** (np.floor(np.log2(max(abs(a), abs(b)))) - 7)
                assert abs(a - b) <= ulp, (row, pair, a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_head_meets_each_hidden_state_in_its_dtype(arch, dtype):
    """The reference casts its float32 master head to the hidden state's
    dtype on every call: float32 in a prefill whose residual a tail block
    promotes, the compute dtype in decode.  The loaded tree holds the head
    in each dtype a mode meets it in (the float32 master, ``head_f32``, only
    where the two differ), so ``logits_of`` casts nothing; the logits tests
    above hold the values against the reference."""
    rcfg, cfg = _cfgs(arch, dtype)
    params = M.load_params(cfg, convert.model_params_from_reference(
        jax.tree.map(np.asarray, ref_instantiate(RM.model_defs(rcfg, 1),
                                                 jax.random.key(0))), "cpu"))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, S + 1)))
    ctx = ShardCtx()
    with torch.inference_mode():
        x_full, _, _ = M.forward(cfg, ctx, params, ids[:, :S])
        _, caches = M.prefill(cfg, ctx, params, ids[:, :S], capacity=S + 8)
        x_dec, _, _ = M.forward(cfg, ctx, params, ids[:, S:], caches=caches,
                             pos=torch.full((2,), S, dtype=torch.int32))
    assert x_full.dtype == M.head_dtype(cfg)
    assert x_dec.dtype == getattr(torch, dtype)
    for x in (x_full, x_dec):
        assert M.head_for(cfg, params, x.dtype).dtype == x.dtype
    assert ("head_f32" in params) == (x_full.dtype != x_dec.dtype)
    drawn = M.init_params(cfg, seed=0, device="cpu")
    assert {k: v.dtype for k, v in _flat(drawn).items()} == {
        k: v.dtype for k, v in _flat(params).items()}
    assert M.load_params(cfg, drawn)["embed"] is drawn["embed"]
    if arch == ARCHS[0]:                 # the full-width configs
        assert M.head_dtype(get_config("recurrentgemma-9b")) == torch.float32
        assert M.head_dtype(get_config("mamba2-130m")) == torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_the_card_matches_reference(arch, dtype, cuda):
    """The port on the card, through its three kernels, against the JAX
    package on the CPU, at the CPU tests' tolerances; greedy tokens equal in
    float32 (bfloat16 GEMMs on the card round otherwise than XLA's)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    before = fa_ops.launches + rg_ops.launches + ssd_ops.launches
    out = _run(arch, dtype, "cuda")
    assert fa_ops.launches + rg_ops.launches + ssd_ops.launches > before
    _close(*out["hidden"], dtype, "hidden")
    _close(*out["prefill_logits"], dtype, "prefill logits", f32_atol=2e-3)
    _close_caches(*out["prefill_caches"], dtype)
    for j, (ref, got) in enumerate(out["decode_logits"]):
        _close(ref, got, dtype, f"decode {j}", f32_atol=2e-3)
    if dtype == "float32":
        for ref, got in out["greedy"]:
            np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(ref))


FULL_WIDTH_PARAMS = {"recurrentgemma-9b": 8_578_519_040,
                     "mamba2-130m": 128_983_488,
                     "olmo-1b": 1_176_764_416,
                     "qwen3-8b": 8_190_735_360,
                     "gemma2-2b": 2_614_341_888,
                     "gemma2-9b": 9_241_705_984,
                     "olmoe-1b-7b": 6_919_100_416,
                     "deepseek-v2-lite-16b": 15_706_484_224,
                     "pixtral-12b": 12_247_782_400,
                     "musicgen-medium": 1_365_543_936}


def test_full_width_defs_match_reference_and_published_sizes():
    """The port's full-width parameter trees have the reference's layout,
    shapes and counts (``FULL_WIDTH_PARAMS``), and its configs the
    reference's values; an unknown name is refused."""
    from repro.configs import get_config as ref_get_config
    from repro.models.common import ParamDef as RefDef
    counts = {}
    for name in FULL_WIDTH_PARAMS:
        ref = {p: (tuple(d.shape), d.init, d.scale)
               for p, d in _flat_ref_defs(RM.model_defs(ref_get_config(name),
                                                        1), RefDef).items()}
        got = {p: (tuple(d.shape), d.init, d.scale)
               for p, d in _flat(M.model_defs(get_config(name), 1)).items()}
        assert got == ref
        counts[name] = sum(int(np.prod(shape)) for shape, _, _ in
                           got.values())
    assert counts == FULL_WIDTH_PARAMS
    for name in FULL_WIDTH_PARAMS:                      # the copies agree
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            ref_get_config(name))
        assert dataclasses.asdict(reduced_config(name)) == dataclasses.asdict(
            ref_reduced_config(name))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_init_params_draws_the_reference_distribution():
    """``init_params`` draws on the device it is given (here the CPU) with
    the reference's rules: truncated normal at fan-in std, gemma norms zero,
    the compute-dtype cast applied as drawn."""
    cfg = reduced_config("recurrentgemma-9b")
    p = M.init_params(cfg, seed=3, device="cpu")
    w = p["scan"][0]["mix"]["w_x"]                 # (1, 128, 128), fan-in 128
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    std = float(w.float().std())
    assert 0.8 / np.sqrt(128) < std < 1.0 / np.sqrt(128)   # ±3σ truncation
    assert float(w.float().abs().max()) <= 3.0 / np.sqrt(128) + 1e-2
    assert float(p["final_norm"]["scale"].abs().max()) == 0.0
    assert p["final_norm"]["scale"].dtype == torch.float32
    again = M.init_params(cfg, seed=3, device="cpu")
    torch.testing.assert_close(again["embed"], p["embed"], rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.init_params(cfg)                     # defaults to the card


def test_lm_module_holds_the_tree():
    cfg = dataclasses.replace(reduced_config("mamba2-130m"), dtype="float32")
    tree = M.init_params(cfg, seed=0, device="cpu")
    lm = M.LM(cfg, tree)
    names = dict(lm.named_buffers())
    assert "scan__0__mix__w_in" in names and "embed" in names
    ids = torch.arange(1, 9, dtype=torch.int64)[None]
    with torch.inference_mode():
        x, _, _ = lm(ids)
        want, _, _ = M.forward(cfg, ShardCtx(), tree, ids)
    torch.testing.assert_close(x, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# test_decode_parity.py, mirrored on the port alone
# ---------------------------------------------------------------------------


def _port_model(arch, **kw):
    """The port's config and the JAX package's drawn weights, loaded; MoE's
    capacity bumped so that no pair is dropped in either mode, as
    ``test_decode_parity.py`` bumps it."""
    rcfg = dataclasses.replace(ref_reduced_config(arch), **kw)
    cfg = dataclasses.replace(reduced_config(arch), **kw)
    if cfg.moe is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=8.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    tree = jax.tree.map(np.asarray, ref_instantiate(
        RM.model_defs(rcfg, 1), jax.random.key(0)))
    return cfg, M.load_params(cfg, convert.model_params_from_reference(
        tree, "cpu"))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m",
                                  "olmo-1b", "qwen3-8b", "gemma2-2b",
                                  "gemma2-9b", "olmoe-1b-7b",
                                  "deepseek-v2-lite-16b"])
def test_decode_matches_full_forward(arch):
    cfg, params = _port_model(arch, dtype="float32")
    ctx = ShardCtx()
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S + 3)))
    with torch.inference_mode():
        x, _, _ = M.forward(cfg, ctx, params, ids)
        _, caches = M.prefill(cfg, ctx, params, ids[:, :S], capacity=S + 8)
        for j in range(3):   # three consecutive decode steps
            pos = torch.full((2,), S + j, dtype=torch.int32)
            logits_d, caches = M.decode_step(cfg, ctx, params,
                                             ids[:, S + j:S + j + 1], pos,
                                             caches)
            gt = M.logits_of(cfg, params, x[:, S + j])
            err = float((logits_d - gt).abs().max())
            assert err < 2e-3, (arch, j, err)


def test_sliding_window_ring_cache():
    """Decode far past the window: the ring cache must overwrite right."""
    cfg, params = _port_model("recurrentgemma-9b", dtype="float32", window=8,
                              long_context_window=8)
    ctx = ShardCtx()
    total, s = 24, 8
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, total + 1)))
    with torch.inference_mode():
        x, _, _ = M.forward(cfg, ctx, params, ids, long_ctx=True)
        _, caches = M.prefill(cfg, ctx, params, ids[:, :s], capacity=s,
                              long_ctx=True)
        for j in range(total - s):
            pos = torch.full((1,), s + j, dtype=torch.int32)
            logits_d, caches = M.decode_step(cfg, ctx, params,
                                             ids[:, s + j:s + j + 1], pos,
                                             caches, long_ctx=True)
    gt = M.logits_of(cfg, params, x[:, total - 1])
    err = float((logits_d - gt).abs().max())
    assert err < 2e-3, err


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-8b"])
def test_sliding_window_ring_cache_attention_only(arch):
    """``test_decode_parity.py``'s ring test for the dense architectures:
    Gemma2's alternating layers and Qwen3's full ones under the long-context
    window, decoded far past it."""
    cfg, params = _port_model(arch, dtype="float32", window=8,
                              long_context_window=8)
    ctx = ShardCtx()
    total, s = 24, 8
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, total + 1)))
    with torch.inference_mode():
        x, _, _ = M.forward(cfg, ctx, params, ids, long_ctx=True)
        _, caches = M.prefill(cfg, ctx, params, ids[:, :s], capacity=s,
                              long_ctx=True)
        for j in range(total - s):
            pos = torch.full((1,), s + j, dtype=torch.int32)
            logits_d, caches = M.decode_step(cfg, ctx, params,
                                             ids[:, s + j:s + j + 1], pos,
                                             caches, long_ctx=True)
    gt = M.logits_of(cfg, params, x[:, total - 1])
    err = float((logits_d - gt).abs().max())
    assert err < 2e-3, (arch, err)


def test_mesh_and_other_archs_are_refused():
    cfg = reduced_config("mamba2-130m")
    shape = InputShape("t", 8, 1, "prefill")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        steps.make_prefill_step(cfg, object(), shape)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        steps.make_serve_step(cfg, object(), shape)
    with pytest.raises(NotImplementedError):
        ShardCtx(model_axis="model", tp=2)
