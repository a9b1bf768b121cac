"""repro_torch: the PyTorch/CUDA port of the ``repro`` VAFL framework.

It mirrors ``repro`` module for module and imports neither JAX nor
``repro``.  Its entry points (``core.federation.Federation``,
``core.runtimes.run_round_based`` and ``run_event_driven``) run on a
CUDA device unless the caller passes ``device="cpu"``; the hot kernels
(``kernels/grad_diff_norm``, ``kernels/topk_quant``) are CUDA C++ built
for Hopper at first use.
"""
