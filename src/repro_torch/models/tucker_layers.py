"""Tucker-factorized LM layers: the paper's technique inside the LM stack.
Port of ``repro.models.tucker_layers``.

* :func:`tucker_linear_apply` — W (m, n) ~ U1 (m, r1) G (r1, r2) U2^T
  (r2, n); the forward pass contracts the factors right to left and never
  builds W. For a matrix, Tucker is two-sided low rank; the factors come
  from the paper's own machinery (QRP on the unfoldings).
* :func:`tucker_expert_apply` — the MoE expert tensor (E, d, ff) is a real
  3-way tensor: core G (rE, rd, rf) and U_E, U_d, U_f, contracted per
  expert at use.
* :func:`tuckerize_linear` / :func:`tuckerize_expert_stack` — compress
  weights with ``repro_torch.tucker.decompose(..., algorithm="dense")``
  (dense HOOI with the paper's QRP) and report the paper-style compression
  ratio.

Everything computes in f32, as the reference does, on the weight's device
(the card when the weight is there). The products are ``torch.matmul`` /
``torch.einsum``: the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.reconstruct import compression_ratio
from repro_torch.tucker import decompose


def tuckerize_linear(w: torch.Tensor, rank: Tuple[int, int], n_iter: int = 3,
                     method: str = "gram") -> Dict[str, torch.Tensor]:
    """Factor a weight matrix with the paper's HOOI (QRP updates)."""
    res = decompose(w.to(torch.float32), list(rank), n_iter=n_iter, method=method,
                    algorithm="dense", device=w.device)
    return {
        "u1": res.factors[0],  # (m, r1)
        "core": res.core,  # (r1, r2)
        "u2": res.factors[1],  # (n, r2)
    }


def tucker_linear_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """y = x @ (U1 G U2^T) computed right to left: W is never built."""
    h = x @ p["u1"].to(x.dtype)  # (..., r1)
    h = h @ p["core"].to(x.dtype)  # (..., r2)
    return h @ p["u2"].to(x.dtype).T  # (..., n)


def tuckerize_expert_stack(experts: torch.Tensor, ranks: Tuple[int, int, int],
                           n_iter: int = 3, method: str = "gram") -> Dict[str, torch.Tensor]:
    """Factor the 3-way (E, d, ff) expert tensor with the paper's HOOI."""
    res = decompose(experts.to(torch.float32), list(ranks), n_iter=n_iter, method=method,
                    algorithm="dense", device=experts.device)
    return {
        "u_e": res.factors[0],
        "u_d": res.factors[1],
        "u_f": res.factors[2],
        "core": res.core,  # (rE, rd, rf)
    }


def tucker_expert_apply(p: Dict[str, torch.Tensor], e: int, x: torch.Tensor) -> torch.Tensor:
    """h = x @ W_e with W_e = core x1 U_E[e] x2 U_d x3 U_f, contracted lazily."""
    g_e = torch.einsum("r,rdf->df", p["u_e"][e].to(torch.float32),
                       p["core"].to(torch.float32))  # (rd, rf)
    h = x.to(torch.float32) @ p["u_d"].to(torch.float32)  # (..., rd)
    h = h @ g_e  # (..., rf)
    return (h @ p["u_f"].to(torch.float32).T).to(x.dtype)


def linear_compression_ratio(m: int, n: int, rank: Tuple[int, int]) -> float:
    return compression_ratio((m, n), rank)


def expert_compression_ratio(e: int, d: int, f: int, ranks: Tuple[int, int, int]) -> float:
    return compression_ratio((e, d, f), ranks)
