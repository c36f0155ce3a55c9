"""PyTorch/CUDA port of the bounded-asynchronous parameter server.

The counterpart of the JAX package ``repro``, module for module: the
consistency spec and simulator (``core``), the threaded parameter-server
runtime with its master state on the card (``runtime``), the LDA workload
(``data``, ``apps``), and hand-written Hopper kernels for the shard apply
and the send order (``kernels``).  It imports ``torch`` and ``numpy`` and
nothing of JAX or of ``repro``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``), which the CPU tests do.
"""
