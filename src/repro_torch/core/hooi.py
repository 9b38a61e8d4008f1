"""HOOI sweeps (paper Alg. 2): one sweep, and the multi-sweep loop.

Port of the sweep machinery of ``repro.core.hooi`` (``HooiResult``, the
sweep, the multi-sweep loop, which a sharded plan runs on its
``ShardedSweepEngine`` unchanged), its
deprecated entry points (shims over ``repro_torch.tucker``) and the paper's
call counts.
:func:`run_sweeps` is the twin of the reference's compiled scan over
sweeps (``_sweep_scan`` inside ``_scan_sweeps_impl``): the same fit
formula, the same ``tol`` rule, the same skip sentinel for sweeps that never
ran, and the fit history copied to the host once per call;
:func:`run_segment`, its loop, also runs a job in resumable segments (the
snapshot layer's twin of ``_segment_scan_sweeps``).

Convergence metric: with orthonormal factors the projection identity
||X - G x {U}||^2 = ||X||^2 - ||G||^2 gives the relative error without
densifying X.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.coo import SparseCOO, fold_dense
from repro_torch.core.engine import SweepEngine
from repro_torch.core.qrp import factor_update

# fit-history entry of a sweep skipped by the ``tol`` early exit. A real
# relative error is >= 0 (or NaN on degenerate input, which counts as a ran
# sweep), so -1 is unambiguous.
_SKIPPED = -1.0


@dataclasses.dataclass
class HooiResult:
    """A finished decomposition: the reference's result fields, and the base
    of :class:`repro_torch.tucker.TuckerResult`.

    Attributes:
      core: (R_1, ..., R_N) core tensor.
      factors: U_n (I_n, R_n) with orthonormal columns.
      rel_error: ||X - Xhat||_F / ||X||_F after the last sweep, a host float
        (the reference's is a device scalar); NaN when no sweep ran.
      fit_history: per-sweep relative error (host numpy).
      engine: the engine that ran (``"cuda"``, ``"torch"``).
    """

    core: torch.Tensor
    factors: List[torch.Tensor]
    rel_error: float
    fit_history: np.ndarray
    engine: str = "torch"

    @classmethod
    def from_history(cls, core, factors, hist, engine: str = "torch", **extra):
        """Build a result from a (possibly empty) fit history: with no
        sweep run the relative error is NaN, never an ``IndexError`` on
        ``hist[-1]``. ``extra`` passes through to a subclass's fields."""
        hist = np.asarray(hist).reshape(-1)
        rel = float(hist[-1]) if hist.size else float("nan")
        return cls(core, list(factors), rel, hist, engine=engine, **extra)


def effective_ranks(shape: Sequence[int], ranks: Sequence[int]) -> List[int]:
    """Clamp the multilinear rank to what is representable:
    R_n <= min(I_n, prod_{t != n} R_t), iterated to a fixpoint."""
    r = [min(int(rr), int(s)) for rr, s in zip(ranks, shape)]
    for _ in range(len(r)):
        changed = False
        for m in range(len(r)):
            bound = int(np.prod([r[t] for t in range(len(r)) if t != m]))
            if r[m] > bound:
                r[m] = bound
                changed = True
        if not changed:
            break
    return r


def init_factors(
    shape: Sequence[int],
    ranks: Sequence[int],
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> List[torch.Tensor]:
    """Alg. 2 line 1: random orthonormal factors. Drawn and orthonormalized
    on the generator's device (the CPU by default, seed 0), so one seed gives
    the same factors whatever ``device`` they are then moved to."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    qdt = torch.promote_types(dtype, torch.float32)
    factors = []
    for i, r in zip(shape, ranks):
        u = torch.randn((int(i), int(r)), generator=g, dtype=qdt, device=g.device)
        q, _ = torch.linalg.qr(u)
        factors.append(q.to(dtype=dtype, device=device))
    return factors


def sparse_sweep(
    coo: SparseCOO,
    factors: List[torch.Tensor],
    ranks: Sequence[int],
    method: str,
    engine: SweepEngine,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One ALS sweep of Alg. 2 (lines 3-9). Returns (factors, core)."""
    n = coo.ndim
    y_n = None
    for mode in range(n):
        y_n = engine.mode_unfolding(coo, factors, mode)
        # pin each factor to its input dtype, as the reference's scan carry.
        factors[mode] = factor_update(y_n, ranks[mode], method).to(factors[mode].dtype)
    # Alg. 2 line 9: G_(N) = U_N^T Y_(N) (Eq. 12), split or fused.
    g_n = engine.core_update(coo, factors, y_n)
    return factors, fold_dense(g_n, n - 1, list(ranks))


def projection_error(xnorm2: torch.Tensor, core: torch.Tensor) -> torch.Tensor:
    """The relative error ||X - Xhat|| / ||X|| from the projection identity
    (orthonormal factors): sqrt(||X||^2 - ||G||^2) / ||X||. With ``xnorm2``
    of shape (k,) and ``core`` (k, R_1, ..., R_N), one error per member."""
    g2 = torch.sum(torch.square(core).reshape(*xnorm2.shape, -1), dim=-1)
    return torch.sqrt(torch.clamp(xnorm2 - g2, min=0.0)) / torch.sqrt(xnorm2)


def fresh_carry(ranks: Sequence[int], core_dtype: torch.dtype, device) -> tuple:
    """The carry ``(core, prev_err, done, n_done)`` of a job before its first
    sweep: a zero core, ``prev_err`` +inf (a device f32 scalar, so the
    ``tol`` rule never fires on the first sweep), not done, no sweep run."""
    return (torch.zeros(tuple(int(r) for r in ranks), dtype=core_dtype, device=device),
            torch.tensor(float("inf"), dtype=torch.float32, device=device), False, 0)


def run_segment(
    coo: SparseCOO,
    factors: Sequence[torch.Tensor],
    carry: tuple,
    xnorm2: torch.Tensor,
    tol: float,
    engine: SweepEngine,
    *,
    ranks: Sequence[int],
    method: str,
    segment_len: int,
    total_sweeps: int,
) -> Tuple[List[torch.Tensor], torch.Tensor, np.ndarray, tuple]:
    """Up to ``segment_len`` ALS sweeps continuing from ``carry``, the twin
    of the reference's ``_sweep_scan`` with ``carry_in`` and
    ``total_sweeps``: the loop of :func:`run_sweeps` run in pieces.

    ``carry`` is ``(core, prev_err, done, n_done)`` (:func:`fresh_carry` for
    a new job): the last core, the last sweep's relative error as a device
    f32 scalar, whether the ``tol`` rule has fired, and the sweeps done. The
    segment stops early once ``done`` or once ``n_done`` reaches the job's
    ``total_sweeps`` budget, so its last segment may be short. Returns
    ``(factors, core, hist, carry)``: ``hist`` the (segment_len,) numpy
    errors of the sweeps that ran, ``_SKIPPED`` after them.

    Each sweep runs exactly the operations of the unsegmented loop, so a
    job cut into segments gives its fit history, factors and core bit for
    bit. The input ``factors`` and carry are never written in place: a
    failed segment can be run again from them.

    The ``tol`` rule is the reference's: done once two consecutive sweeps'
    errors differ by less than ``tol`` (never against +inf, never on NaN).
    The reference decides it on the device inside one compiled program;
    PyTorch cannot branch on a device value without reading it, so with
    ``tol > 0`` this loop reads one flag a sweep. With ``tol == 0`` nothing
    is read until the segment's history, once, at its end.
    """
    core, prev_err, done, n_done = carry
    fs = list(factors)
    core_dtype = torch.promote_types(coo.values.dtype, torch.float32)
    errs = []
    while not done and len(errs) < segment_len and n_done < total_sweeps:
        fs, g = sparse_sweep(coo, fs, ranks, method, engine)
        core = g.to(core_dtype)
        err = projection_error(xnorm2, core).to(torch.float32)
        errs.append(err)
        n_done += 1
        if tol > 0:
            done = bool(torch.isfinite(prev_err) & (torch.abs(prev_err - err) < tol))
        prev_err = err
    hist = np.full((segment_len,), _SKIPPED, dtype=np.float32)
    if errs:
        hist[: len(errs)] = torch.stack(errs).cpu().numpy()  # the one device->host copy
    return fs, core, hist, (core, prev_err, done, n_done)


def run_sweeps(
    coo: SparseCOO,
    factors: Sequence[torch.Tensor],
    xnorm2: torch.Tensor,
    tol: float,
    engine: SweepEngine,
    *,
    ranks: Sequence[int],
    method: str,
    n_iter: int,
) -> Tuple[List[torch.Tensor], torch.Tensor, np.ndarray]:
    """Up to ``n_iter`` (>= 1) ALS sweeps with the ``tol`` early exit: one
    :func:`run_segment` of the whole budget from a fresh carry.

    Returns ``(factors, core, hist)``; ``hist`` is the (n_iter,) numpy fit
    history, with ``_SKIPPED`` for sweeps the early exit skipped.
    """
    carry = fresh_carry(ranks, torch.promote_types(coo.values.dtype, torch.float32),
                        xnorm2.device)
    fs, core, hist, _ = run_segment(coo, factors, carry, xnorm2, tol, engine, ranks=ranks,
                                    method=method, segment_len=n_iter, total_sweeps=n_iter)
    return fs, core, hist


def batched_sweep(
    stacked: SparseCOO,
    fs: List[torch.Tensor],
    active: Optional[torch.Tensor],
    ranks: Sequence[int],
    method: str,
    engine: SweepEngine,
    *,
    shape: Sequence[int],
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One ALS sweep of :func:`run_sweeps_batched` over the k stacked
    members: each mode's unfolding in one call of ``engine``, the factor
    update as one (k, I_n, K) batch, and the core update once per member on
    its rows. ``fs`` holds the stacked factors (k I_m, R_m), replaced in
    place in the list; ``active`` (k,) bool or None keeps a settled member's
    factors. Returns ``(fs, cores)``, the cores (k, R_1, ..., R_N)."""
    k = stacked.shape[0] // shape[0]
    n = len(shape)
    y_n = None
    for mode in range(n):
        y_n = engine.mode_unfolding(stacked, fs, mode)
        u = factor_update(y_n.view(k, shape[mode], -1), ranks[mode], method)
        u = u.to(fs[mode].dtype)
        if active is not None:  # settled members keep their factors
            u = torch.where(active[:, None, None], u, fs[mode].reshape(u.shape))
        fs[mode] = u.reshape(k * shape[mode], -1)
    # Alg. 2 line 9 per member: G_(N) = U_N^T Y_(N) on the members' rows
    rows = shape[n - 1]
    g = torch.stack([
        fold_dense(engine.core_unfolding(y_n[i * rows:(i + 1) * rows],
                                         fs[n - 1][i * rows:(i + 1) * rows]),
                   n - 1, list(ranks))
        for i in range(k)
    ])
    return fs, g


def run_sweeps_batched(
    stacked: SparseCOO,
    factors: Sequence[Sequence[torch.Tensor]],
    xnorm2: torch.Tensor,
    tol: float,
    engine: SweepEngine,
    *,
    ranks: Sequence[int],
    method: str,
    n_iter: int,
) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor], np.ndarray]:
    """:func:`run_sweeps` for k same-shape tensors at once, one set of
    launches for all of them: the twin of the reference's vmapped program
    (``_batched_scan_sweeps``).

    ``stacked`` is the block-diagonal stack of the k members, of shape
    (k I_1, ..., k I_N) (:func:`~repro_torch.sparse.layout.stack_coo_batch`);
    ``factors`` holds each member's initial factors, stacked here into
    (k I_m, R_m), and ``xnorm2`` the members' squared norms, (k,). Each
    mode's unfolding is one call of ``engine`` over the stack: the k
    members' unfoldings one under the other. The factor update runs on those
    as one (k, I_n, K) batch; the core update G_i = U_N,i^T Y_(N),i once per
    member, on row views.

    The ``tol`` rule holds per member, as under the reference's vmap: a
    member whose fit has settled keeps its factors and core from then on
    (``torch.where``; it stays in the stack, whose schedules do not
    change) and its later history entries are ``_SKIPPED``. With ``tol > 0``
    the loop reads one flag a sweep and stops once every member is done;
    with ``tol == 0`` nothing is read back until the (k, n_iter) history.

    Returns each member's ``(factors, core)`` as separate tensors, and the
    history.
    """
    k = len(factors)
    shape = tuple(s // k for s in stacked.shape)
    n = len(shape)
    fs = [torch.cat([f[m] for f in factors]) for m in range(n)]  # (k I_m, R_m)
    core_dtype = torch.promote_types(stacked.values.dtype, torch.float32)
    skipped = torch.full((k,), _SKIPPED, dtype=torch.float32, device=xnorm2.device)
    prev_err = torch.full((k,), float("inf"), dtype=torch.float32, device=xnorm2.device)
    active = None  # every member runs until the tol rule stops one
    core = None
    errs = []
    for _ in range(n_iter):
        fs, g = batched_sweep(stacked, fs, active, ranks, method, engine, shape=shape)
        g = g.to(core_dtype)
        err = projection_error(xnorm2, g).to(torch.float32)
        if active is None:
            core = g
            errs.append(err)
        else:
            core = torch.where(active.view((k,) + (1,) * n), g, core)
            errs.append(torch.where(active, err, skipped))
        if tol > 0:
            ran = active if active is not None else torch.ones_like(prev_err, dtype=torch.bool)
            done = ran & torch.isfinite(prev_err) & (torch.abs(prev_err - err) < tol)
            prev_err = torch.where(ran, err, prev_err)
            active = ran & ~done
            if not bool(active.any()):  # the one read a sweep
                break
    hist = np.full((k, n_iter), _SKIPPED, dtype=np.float32)
    hist[:, :len(errs)] = torch.stack(errs, 1).cpu().numpy()  # the one copy of the history
    out = [[f[i * s:(i + 1) * s].clone() for f, s in zip(fs, shape)] for i in range(k)]
    return out, [core[i].clone() for i in range(k)], hist


# -- deprecation shims over repro_torch.tucker, as in the reference ----------


def hooi_dense(x, ranks: Sequence[int], n_iter: int = 5, method: str = "svd",
               generator: Optional[torch.Generator] = None, tol: float = 0.0,
               factors_init=None, device="cuda"):
    """Dense HOOI (paper Alg. 1): ``method`` 'svd' (Alg. 1 line 5),
    'householder' or 'gram' (the paper's QRP, Table II).

    .. deprecated:: use ``repro_torch.tucker`` (``decompose(x, ranks)`` or
       ``plan(TuckerSpec(..., algorithm="dense"))``); this shim delegates.
    """
    from repro_torch import tucker

    warnings.warn("hooi_dense is deprecated; use repro_torch.tucker.decompose / plan "
                  "(TuckerSpec(algorithm='dense')).", DeprecationWarning, stacklevel=2)
    spec = tucker.TuckerSpec(shape=tuple(x.shape), ranks=tuple(ranks), method=method,
                             n_iter=n_iter, tol=tol, algorithm="dense")
    return tucker.plan(spec, device=device)(x, generator=generator, factors_init=factors_init)


def hooi_sparse(coo: SparseCOO, ranks: Sequence[int], n_iter: int = 5,
                method: str = "householder", generator: Optional[torch.Generator] = None,
                tol: float = 0.0, engine: Union[str, SweepEngine] = "auto",
                pipeline: str = "scan", device="cuda"):
    """The paper's sparse Tucker decomposition (Alg. 2). ``engine`` is an
    engine name or a prebuilt :class:`SweepEngine` (whose cached schedules
    it reuses); ``pipeline`` 'scan' or 'python'.

    .. deprecated:: use ``repro_torch.tucker`` (``plan(spec)`` once, then
       call it on many tensors, or ``decompose``); this shim delegates.
    """
    from repro_torch import tucker

    warnings.warn("hooi_sparse is deprecated; use repro_torch.tucker.plan / decompose.",
                  DeprecationWarning, stacklevel=2)
    prebuilt = engine if isinstance(engine, SweepEngine) else None
    spec = tucker.TuckerSpec(shape=tuple(coo.shape), ranks=tuple(ranks), method=method,
                             engine=prebuilt.name if prebuilt is not None else engine,
                             pipeline=pipeline, n_iter=n_iter, tol=tol)
    return tucker.plan(spec, device=device, engine=prebuilt)(coo, generator=generator)


def tucker_complete_dense(coo: SparseCOO, ranks: Sequence[int], n_rounds: int = 10,
                          n_iter: int = 2, method: str = "gram",
                          generator: Optional[torch.Generator] = None, device="cuda"):
    """EM Tucker completion: dense HOOI rounds with the missing entries
    imputed from the last reconstruction (a dense working set, for the
    small and medium problems of the paper's use cases).

    .. deprecated:: use ``repro_torch.tucker`` with ``algorithm="complete"``;
       this shim delegates.
    """
    from repro_torch import tucker

    warnings.warn("tucker_complete_dense is deprecated; use repro_torch.tucker.decompose("
                  "..., algorithm='complete') / plan.", DeprecationWarning, stacklevel=2)
    spec = tucker.TuckerSpec(shape=tuple(coo.shape), ranks=tuple(ranks), method=method,
                             n_iter=n_iter, n_rounds=n_rounds, algorithm="complete")
    return tucker.plan(spec, device=device)(coo, generator=generator)


def sweep_call_counts(shape: Sequence[int], ranks: Sequence[int], nnz: int,
                      n_iter: int) -> dict:
    """The paper's per-dataset totals (Table V): QRP calls, Kron rows and
    TTMs. A sweep makes N QRP calls, nnz N Kron rows and one TTM."""
    n = len(shape)
    return {"qrp_calls": n * n_iter + (n - 1), "kron_calls": nnz * n_iter,
            "ttm_calls": n_iter}
