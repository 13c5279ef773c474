"""PyTorch/CUDA port of the DNN-partitioning explorer.

Mirrors the module paths of the JAX package ``repro``: every module here
has one counterpart there, which is the reference it is tested against.
The package imports ``torch`` and ``numpy`` only.  Its entry points
(``repro_torch.explore.run_spec``, ``run_search``, ``TorchNSGA2Search``)
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
