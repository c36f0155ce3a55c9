"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points default to the card."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.apps import lda
from repro_torch.core import policies
from repro_torch.data import synthetic_corpus
from repro_torch.runtime import PSRuntime, RuntimeConfig, recover_to_vc

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_pulls_in_no_jax_and_no_reference():
    mods = _port_modules()
    assert "repro_torch.runtime.shard" in mods and len(mods) > 20
    for m in ("repro_torch.core.sync", "repro_torch.kernels.vap_accum.ops",
              "repro_torch.core.theory", "repro_torch.core.tables",
              "repro_torch.core.client", "repro_torch.apps.mf",
              "repro_torch.apps.logreg", "repro_torch.configs.registry",
              "repro_torch.models.common", "repro_torch.models.attention",
              "repro_torch.models.recurrent", "repro_torch.models.moe",
              "repro_torch.models.model", "repro_torch.launch.steps",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.ssd_scan.ops",
              "repro_torch.kernels.rglru_scan.ops",
              "repro_torch.runtime.serving",
              "repro_torch.runtime.serving.replica",
              "repro_torch.runtime.serving.gateway"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or "
            "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_names_jax_or_the_reference():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|"
                     r"import repro\s*$|from repro import)", re.M)
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("*.py")))
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


def test_entry_points_default_to_the_card():
    cfg = RuntimeConfig(2, policies.bsp(), {"a": np.zeros((3, 2))})
    assert cfg.device == "cuda"
    corpus = synthetic_corpus(n_docs=4, vocab_size=10, n_topics=2,
                              doc_len=5, seed=0)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSRuntime(cfg)
    # run_lda with every default goes to the runtime on the card, and
    # run_lda_spmd stacks its replicas there
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lda.run_lda(corpus, n_topics=2, policy=policies.bsp(), n_workers=2,
                    n_clocks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lda.run_lda_spmd(corpus, n_topics=2, n_workers=2, n_clocks=1)
    # WAL recovery replays on the card unless the caller asks for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recover_to_vc({"a": np.zeros((3, 2))}, "no-such-wal-dir", n_proc=1)


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_lda_simulator_refuses_a_device(device):
    """The simulator is host numpy: it raises where asked for the card
    rather than run on the CPU all the same."""
    corpus = synthetic_corpus(n_docs=4, vocab_size=10, n_topics=2,
                              doc_len=5, seed=0)
    with pytest.raises(ValueError, match="runs on the host"):
        lda.run_lda(corpus, n_topics=2, policy=policies.bsp(), n_workers=2,
                    n_clocks=1, backend="sim", device=device)
