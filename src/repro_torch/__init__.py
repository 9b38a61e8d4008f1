"""repro_torch — the PyTorch/CUDA port of ``repro`` (sparse Tucker / HOOI).

The same plan/execute front-end as the JAX package, running on an NVIDIA
card by default:

    from repro_torch import tucker

    res = tucker.decompose(coo, (16, 16, 16), n_iter=5)   # device="cuda"
    res = tucker.decompose(coo, (16, 16, 16), device="cpu")

On a CUDA device the sweep's two hot loops run on hand-written CUDA kernels
(``kernels/csrc``); on the CPU the same code path runs their plain PyTorch
versions. The package imports ``torch`` and ``numpy`` only.
"""
