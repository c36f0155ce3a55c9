"""PyTorch/CUDA port of the bounded-asynchronous parameter server.

The counterpart of the JAX package ``repro``, module for module: the
consistency spec, simulator and SPMD sync layer (``core``), the threaded
parameter-server runtime with its master state on the card (``runtime``),
the LDA, MF and logistic-regression workloads (``data``, ``apps``), LLM
serving at tp = 1 for the recurrent-mixer architectures (``configs``,
``models``, ``launch``), and hand-written Hopper kernels for the shard
apply, the send order, the sync layer's accumulate and the prefill's
attention and scans (``kernels``).  It imports ``torch`` and ``numpy`` and
nothing of JAX or of ``repro``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``), which the CPU tests do.
"""

import torch as _torch

# PyTorch's CPU exp runs MKL's vector math over 2,048-element chunks on the
# OpenMP threads.  When a process's first call to it is multi-threaded, a
# chunk can come out of a less accurate exp (relative error ~5e-5 against
# ~3e-8), so the plain RG-LRU's gates differed between two identical calls.
# One call on one thread first initialises it; every later call is exact.
_torch.exp(_torch.zeros(1))
