"""``chip_smoke.py``'s own checks of the dense, MoE and MLA paths, on the
CPU at reduced size (no JAX: the smoke holds the port against itself).

* The decode parity (``decode_parity``): where a request's MoE routes
  differ between decode and the full forward in some layer, decode runs
  again with the full forward's routes forced (``forced_routes``), so every
  request is held; the check still fails when no request is held.
* The MoE routes under remat (``moe_routes``, ``moe_step_routes``): the
  backward's recomputation of a unit routes every pair as its forward did,
  and the forward's drops are counted per layer.
* The launch counts a train step implies (``train_launches_per_step``) at
  the five training cells' depths, and the launches a prefill makes at
  each served model's full depth (``SERVE_LAUNCHES``,
  ``SERVE_FLASH_BY_WINDOW``), from ``M.layer_metas``.
* The decode parity of a frontend model gives the prefill and the full
  forward the same embeddings (``frontend_embeddings``).
* The plain flash backward over slices of the batch and the kv heads
  (``flash_bwd_plain``) is the whole call's.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.common import ShardCtx, instantiate_tree, \
    tree_leaves, tree_map

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
BATCH, PROMPT = 3, 16


def _deepseek(seed=0):
    """Reduced DeepSeek in float32 at the smoke's parity capacity factor,
    under which neither path drops a pair."""
    cfg = reduced_config(ARCH)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=chip_smoke.PARITY_CAPACITY_FACTOR))
    params = M.init_params(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                            (BATCH, PROMPT)))
    return cfg, params, prompts


def _flip_row0_in_decode(monkeypatch):
    """Route decode's row 0 (a call of BATCH tokens) to its least likely
    expert in place of its K-th choice, at every MoE layer."""
    orig = moe.route

    def route(probs, k):
        vals, ids = orig(probs, k)
        if probs.shape[0] == BATCH:
            worst = torch.argmin(probs[0])
            vals, ids = vals.clone(), ids.clone()
            ids[0, -1], vals[0, -1] = worst, probs[0, worst]
        return vals, ids

    monkeypatch.setattr(moe, "route", route)


def test_decode_parity_holds_a_flipped_request_by_forcing_its_routes(
        monkeypatch):
    cfg, params, prompts = _deepseek()
    _flip_row0_in_decode(monkeypatch)
    par = chip_smoke.decode_parity("reduced deepseek", cfg, params, prompts,
                                   PROMPT + 4, torch.device("cpu"))
    assert {f["row"] for f in par["flips"]} == {0}
    assert par["rows_routed_alike"] == [1, 2]
    assert par["forced_replay"]["route_flips"] == 0
    assert par["held"] == [0, 1, 2]
    # float32 on the CPU: the two paths agree to their rounding
    assert par["parity"] < 1e-4, par["parity"]
    assert moe.route.__name__ == "route" and moe.capacity(
        cfg.moe, 8) == max(1, int(np.ceil(8 * cfg.moe.top_k
                                          * cfg.moe.capacity_factor
                                          / cfg.moe.n_experts)))


def test_decode_parity_without_the_flip_replays_nothing():
    cfg, params, prompts = _deepseek(1)
    par = chip_smoke.decode_parity("reduced deepseek", cfg, params, prompts,
                                   PROMPT + 4, torch.device("cpu"))
    assert par["flips"] == [] and par["forced_replay"] is None
    assert par["held"] == par["rows_routed_alike"] == [0, 1, 2]
    assert par["parity"] < 1e-4, par["parity"]


def test_decode_parity_fails_when_no_request_is_held(monkeypatch):
    cfg, params, prompts = _deepseek()
    monkeypatch.setattr(chip_smoke, "route_agreement",
                        lambda dec, full, rows, at: ([], [{"row": 0}], []))
    with pytest.raises(AssertionError, match="every request's routes"):
        chip_smoke.decode_parity("reduced deepseek", cfg, params, prompts,
                                 PROMPT + 4, torch.device("cpu"))


def test_remat_recomputes_the_moe_routes_of_the_forward():
    """Reduced DeepSeek (a dense first layer outside the units, then MoE
    units) with a second unit: lm_loss under remat notes each MoE layer's
    routes once in the forward and once in the backward's recomputation,
    and the two agree pair for pair."""
    cfg = dataclasses.replace(reduced_config(ARCH), dtype="float32",
                              n_layers=3)
    _, unit, n_units, _ = M.group_layers(cfg, M.layer_metas(cfg))
    assert n_units == 2 and [m.use_moe for m in unit] == [True]
    gen = torch.Generator().manual_seed(2)
    params = instantiate_tree(M.model_defs(cfg, 1), gen, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 32)))
    with chip_smoke.moe_routes() as routes:
        loss, _ = M.lm_loss(cfg, ShardCtx(), params, ids, ids, remat=True,
                            chunk=8)
        torch.autograd.grad(loss, leaves)
    assert [r["recompute"] for r in routes] == [False, False, True, True]
    drops, differ = chip_smoke.moe_step_routes(routes, cfg, remat=True)
    assert differ == 0
    assert drops == [int((~r["keep"]).sum()) for r in routes[:2]]
    # a recomputation that routed otherwise is counted
    routes[2] = {**routes[2], "ids": torch.roll(routes[2]["ids"], 1, 1)}
    assert chip_smoke.moe_step_routes(routes, cfg, remat=True)[1] > 0
    # without remat nothing is recomputed
    with chip_smoke.moe_routes() as plain:
        loss, _ = M.lm_loss(cfg, ShardCtx(), params, ids, ids, remat=False,
                            chunk=8)
        torch.autograd.grad(loss, leaves)
    assert chip_smoke.moe_step_routes(plain, cfg, remat=False) == (drops, 0)


@pytest.mark.parametrize("cell,want,by_window", [
    ("TRAIN_RG", {"flash_attention": 2, "flash_attention_bwd": 1,
                  "rglru_bf16": 4, "rglru_f32": 2, "rglru_bwd_bf16": 2,
                  "rglru_bwd_f32": 2}, {2048: 1}),
    ("TRAIN_GEMMA2", {"flash_attention": 8, "flash_attention_bwd": 4},
     {4096: 2, None: 2}),
    ("TRAIN_DEEPSEEK", {"flash_attention": 5, "flash_attention_bwd": 3},
     {None: 3}),
    ("TRAIN_PIXTRAL", {"flash_attention": 6, "flash_attention_bwd": 3},
     {None: 3}),
    ("TRAIN_MUSICGEN", {"flash_attention": 96, "flash_attention_bwd": 48},
     {None: 48})])
def test_train_launches_per_step_follow_the_layers(cell, want, by_window):
    """RecurrentGemma at 5 layers (a rec/rec/attn unit, the float32 tail),
    Gemma2 at 4 (two local/global units), DeepSeek at 3 (the dense first
    layer, run once, then two MoE units, run twice under remat), Pixtral
    at 3 and MusicGen at its full 48 (one-layer units, each run twice)."""
    cell = getattr(chip_smoke, cell)
    cfg = dataclasses.replace(get_config(cell.arch), n_layers=cell.layers)
    assert chip_smoke.train_launches_per_step(cfg, True) == (want, by_window)


@pytest.mark.parametrize("cell,want", [
    ("TRAIN_RG", {("rglru_scan_bwd", torch.bfloat16, None),
                  ("rglru_scan_bwd", torch.float32, None),
                  ("flash_attention_bwd", torch.bfloat16, 2048)}),
    ("TRAIN_GEMMA2", {("flash_attention_bwd", torch.bfloat16, 4096),
                      ("flash_attention_bwd", torch.bfloat16, None)}),
    ("TRAIN_DEEPSEEK", {("flash_attention_bwd", torch.bfloat16, None)}),
    ("TRAIN_PIXTRAL", {("flash_attention_bwd", torch.bfloat16, None)}),
    ("TRAIN_MUSICGEN", {("flash_attention_bwd", torch.bfloat16, None)})])
def test_train_first_backward_calls_follow_the_layers(cell, want):
    """The backwards' first calls each train cell keeps for the kernels
    phase: RecurrentGemma's RG-LRU in both dtypes and its windowed flash,
    Gemma2's local and global flash, DeepSeek's MLA flash, Pixtral's and
    MusicGen's causal flash."""
    cell = getattr(chip_smoke, cell)
    cfg = dataclasses.replace(get_config(cell.arch), n_layers=cell.layers)
    counts, by_window = chip_smoke.train_launches_per_step(cfg, True)
    assert chip_smoke.train_first_bwd_keys(cfg, counts, by_window) == want


@pytest.mark.parametrize("name", chip_smoke.SERVE_MODELS)
def test_serve_launches_follow_the_layers(name):
    """A prefill launches each mixer kernel once a layer of its kind at
    the model's full depth, flash_attention's by window (Pixtral 40 and
    MusicGen 48, all without a window)."""
    import collections
    metas = M.layer_metas(get_config(name))
    kernel = {"attn": "flash_attention"}
    if get_config(name).recurrent is not None:
        kernel["rec"] = {"rglru": "rglru_scan", "mamba2": "ssd_scan"}[
            get_config(name).recurrent.kind]
    want = dict(collections.Counter(kernel[m.kind] for m in metas))
    assert chip_smoke.SERVE_LAUNCHES[name] == want
    windows = collections.Counter(m.window for m in metas
                                  if m.kind == "attn")
    assert chip_smoke.SERVE_FLASH_BY_WINDOW.get(name, {}) == dict(windows)
    assert set(chip_smoke.SERVE_LAUNCHES) == set(chip_smoke.SERVE_MODELS)


@pytest.mark.parametrize("name", ["pixtral-12b", "musicgen-medium"])
def test_decode_parity_feeds_the_frontend_embeddings(name):
    """Reduced, float32: decode after a prefill with the embeddings agrees
    with the full forward over the same embeddings, and the embeddings
    reach the logits (without them the prefill's logits differ)."""
    cfg = dataclasses.replace(reduced_config(name), dtype="float32")
    params = M.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                            (BATCH, PROMPT)))
    extra = chip_smoke.frontend_embeddings(cfg, rng, BATCH, "cpu")
    assert extra["extra_emb"].shape == (BATCH, 8, cfg.d_model)
    assert chip_smoke.frontend_embeddings(reduced_config("olmo-1b"), rng,
                                          BATCH, "cpu") == {}
    par = chip_smoke.decode_parity(name, cfg, params, prompts, PROMPT + 4,
                                   torch.device("cpu"), extra["extra_emb"])
    assert par["held"] == [0, 1, 2] and par["parity"] < 1e-4, par["parity"]
    bare = chip_smoke.decode_parity(name, cfg, params, prompts, PROMPT + 4,
                                    torch.device("cpu"))
    assert float((bare["logits_p"] - par["logits_p"]).abs().max()) > 1e-4


def test_plain_flash_backward_over_slices_is_the_whole_call(monkeypatch):
    gen = torch.Generator().manual_seed(5)
    b, s, kvh, G, dh, dv = 2, 40, 3, 2, 16, 8
    q, k, v, do = (torch.randn(shape, generator=gen) for shape in (
        (b, s, kvh, G, dh), (b, s, kvh, dh), (b, s, kvh, dv),
        (b, s, kvh, G, dv)))
    pos = torch.arange(s, dtype=torch.int32)
    want = fa_ref.attention_bwd(q, k, v, pos, pos, 16, 30.0, do)
    # two kv heads a slice, one batch row at a time
    monkeypatch.setattr(chip_smoke, "FLASH_PLAIN_SLICE_BYTES",
                        2 * 4 * G * s * s)
    got = chip_smoke.flash_bwd_plain(q, k, v, pos, pos, 16, 30.0, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
