"""Launch-parameter autotuner for the sparse sweep kernels.

Port of ``repro.kernels.autotune``. The paper's FPGA sizes its dataflow
buffers once per (tensor, rank) problem at synthesis time; on this card the
analogue is choosing the sweep's launch parameters (:class:`BlockConfig`):
the schedule's geometry ``bn`` (nonzeros per block) and ``bi`` (output rows
per block), which decide the padding of the slot cache that the unfolding
kernels read (``sparse/layout.py::build_schedule``); ``slots_per_part``, the
row split of kernels 1 and 5 (one warp a range, ``layout.row_parts``) and
the range length of the order >= 4 chain kernel (``layout.even_cuts``); and
the core update's ``layout``, "split" (kernel 2 on the last unfolding) or
"fused" (kernel 5, which rebuilds the unfolding from the nonzeros). The
reference's TTM tile ``bl``/``bk`` has no counterpart: kernel 2's tile is
compiled in (``csrc/ttm.cu``) and its split is derived from the shapes
(``ttm_kernel.py``). The search runs once per problem fingerprint and the
winner is kept in an on-disk JSON table, so a warm ``tucker.plan`` pays no
search (``COUNTERS``).

Search = a prune, a ranking and short timed trials:

1. each candidate's shared memory is computed with the launchers' own
   formulas at the problem's ranks (kernel 1's staging per warp,
   ``csrc/kron_scatter.cu``; kernel 5's CTA, ``csrc/kron_scatter_ttm.cu``;
   at order >= 4 the chain kernel's, ``csrc/kron_chain_scatter.cu``)
   and held against the card's opt-in limit per block (on the CPU, the
   H100's, so both see one candidate list); a candidate whose modeled
   padded slot cache exceeds ``SLOT_CACHE_GROWTH`` x the default's is
   dropped too;
2. the survivors are ranked by the bytes a sweep moves under them (the
   padded slots read, the unfoldings written and read back, at order >= 4
   the chain kernel's partial rows; the fused layout writes no last
   unfolding), ties going to the candidate closest to the default;
3. the first ``max_trials`` (the default always first among them) are
   timed on a synthetic problem of the fingerprint's nnz bucket, at most
   ``TRIAL_NNZ_CAP`` nonzeros: the N unfoldings and the core update of one
   sweep with fixed factors (kernels 1 + 2, 1 + 5, or the chain kernel and
   2), which is all a configuration changes. The fastest wins.

The table key is a stable fingerprint of shape, ranks, the nnz bucket
(powers of 2), dtype, precision and the backend (``"cuda:<name>:sm_XY"`` or
``"cpu"``). ``REPRO_TORCH_AUTOTUNE_TABLE`` relocates the table (default
``~/.cache/repro_torch/autotune.json``); the reference keeps its own, and
neither reads the other's entries.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels.kron_kernel import launch_route
from repro_torch.obs import event as _obs_event
from repro_torch.sparse.layout import chain_range_slots
from repro_torch.obs import registry as _obs_registry
from repro_torch.obs import span as _obs_span

TABLE_ENV = "REPRO_TORCH_AUTOTUNE_TABLE"
TABLE_VERSION = 1
LAYOUTS = ("split", "fused")

# the opt-in shared memory of one block on an H100 (227 KB,
# cudaDevAttrMaxSharedMemoryPerBlockOptin): the prune's limit on the CPU
H100_SMEM_PER_BLOCK_OPTIN = 232448
# a candidate's modeled padded slot cache may be at most this many times the
# default's (padding slots are read by every kernel and summed by none)
SLOT_CACHE_GROWTH = 2.0
# trials time a synthetic problem of the fingerprint's nnz bucket, capped
# here: at 2^24 nonzeros kernel 1 takes ~0.7 ms a mode on an H100, well
# above the launch noise, and a search stays under a second (PERF.md)
TRIAL_NNZ_CAP = 1 << 24

# one process-wide counter set, reset by tests: a warm plan must show zero
# searches and zero trials
COUNTERS: Dict[str, int] = {"searches": 0, "trials": 0, "table_hits": 0}

# registry twins of COUNTERS, cumulative (reset_counters leaves them)
_REG_COUNTERS = {
    k: _obs_registry.counter(f"repro_autotune_{k}_total", f"autotune {k.replace('_', ' ')}")
    for k in COUNTERS
}


def _count(kind: str) -> None:
    COUNTERS[kind] += 1
    _REG_COUNTERS[kind].inc()


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


class BlockConfig(NamedTuple):
    """One point of the search space: the sweep kernels' launch parameters.
    (Kernel 2's tile, the reference's ``bl``/``bk``, is compiled in.)"""

    bn: int = 128  # nonzeros per schedule block
    bi: int = 128  # output rows per schedule block
    slots_per_part: int = 1024  # kernels 1 and 5: slots per warp's row range
    layout: str = "split"  # "split" | "fused" (kernel 5 for the core update)


# the hand-picked values (kron_kernel.DEFAULT_BN / DEFAULT_BI,
# layout.SLOTS_PER_PART, the split core update): always the first candidate,
# so the tuned pick is never slower than the default in its trial
DEFAULT_CONFIG = BlockConfig()


def nnz_bucket(nnz: int) -> int:
    """Power-of-2 bucket of a nonzero count, the fingerprint's nnz term."""
    n = max(1, int(nnz))
    return 1 << (n - 1).bit_length()


def backend_of(device) -> str:
    """The fingerprint's backend: ``"cuda:<device name>:sm_<major><minor>"``
    on a CUDA device, ``"cpu"`` on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda:{torch.cuda.get_device_name(dev)}:sm_{major}{minor}"


def _key(shape, ranks, nnz, dtype, precision, backend) -> dict:
    return {"package": "repro_torch", "shape": [int(s) for s in shape],
            "ranks": [int(r) for r in ranks], "nnz_bucket": nnz_bucket(nnz),
            "dtype": str(dtype), "precision": str(precision), "backend": str(backend)}


def fingerprint(shape: Sequence[int], ranks: Sequence[int], nnz: int, *,
                dtype: str = "float32", precision: str = "fp32",
                backend: str = "cpu") -> str:
    """Stable identity of one tuning problem (the table key)."""
    blob = json.dumps(_key(shape, ranks, nnz, dtype, precision, backend), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Cost model: shared memory (prune), padded slot cache (prune), bytes a
# sweep (ranking).
# ---------------------------------------------------------------------------

# compile-time constants of csrc/kron_walk.cuh and csrc/kron_scatter_ttm.cu,
# and _K_TA, the f64 chain kernel's f_1 columns a lane (kron_chain_scatter.cu)
_K_SLOTS, _K_STAGES, _K_WARPS, _K_NT, _K_TA = 32, 2, 8, 2, 4
_K_BLOCK_COLS, _K_DEPTH = 256, 2
# operand factors csrc/kron_chain_scatter.cu is compiled for (kMaxOps,
# kron_kernel.MAX_CHAIN_OPERANDS): orders 4 to 6
_CHAIN_MAX_OPS = 5


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _operand_ranks(ranks: Sequence[int], mode: int):
    """(ra, rb) of kernel 1 at ``mode``: the non-mode ranks in descending
    mode order (``layout.operand_modes``); rb = 0 marks a 2-way tensor."""
    rs = [ranks[t] for t in range(len(ranks) - 1, -1, -1) if t != mode]
    return rs[0], (rs[1] if len(rs) > 1 else 0)


def _elem_bytes(precision: str, dtype: str) -> int:
    """Bytes of one staged factor element: bf16 under ``bf16_fp32acc``, else
    the dtype's (f32 4, f64 8)."""
    if precision == "bf16_fp32acc":
        return 2
    return 8 if str(dtype) == "float64" else 4


def _ring_bytes(ra: int, rb: int, precision: str, dtype: str = "float32") -> int:
    """One warp's staging ring of the walk (kernels 1 and 5 stage alike), as
    ``kron_scatter_launch`` and ``kron_scatter_ttm.cu::shape_of`` compute it
    from ``kron_walk.cuh::staged_strides``: the factor rows padded to 16
    bytes, in strides of whole 16-element blocks, on every route."""
    elem = _elem_bytes(precision, dtype)
    per16 = 16 // elem
    lda, ldb = _round_up(ra, per16), (_round_up(rb, per16) if rb else 0)
    sla = _round_up(max(lda, _round_up(ra, 16)), 16)
    slb = _round_up(max(ldb, _round_up(rb, 8 * _K_NT)), 16) if ldb else 0
    return _K_STAGES * _K_SLOTS * (sla + slb) * elem


def _chain_ring_bytes(rs: Sequence[int], precision: str, dtype: str = "float32") -> int:
    """One warp's staging ring of the order >= 4 chain kernel for operand
    ranks ``rs`` (``layout.operand_modes`` order), as
    ``kron_chain_scatter.cu::dims_of`` computes it: each factor's rows
    padded to 16 bytes; on the tensor-core routes (fp32's 3xTF32,
    bf16_fp32acc's 2xTF32) strides of whole 16-element blocks, on the f64
    CUDA-core route f_1 in whole 4-column lane tiles and every row a
    multiple of 8 elements. Under ``bf16_fp32acc`` f_1 and f_2 are staged in
    bf16 and the later factors in f32."""
    f64 = str(dtype) == "float64" and precision == "fp32"
    tc = launch_route("fused_kron_chain_scatter", torch.float64 if f64 else torch.float32,
                      precision) != "cuda_cores"
    total = 0
    for f, r in enumerate(rs):
        elem = 8 if f64 else 2 if precision == "bf16_fp32acc" and f < 2 else 4
        ld = _round_up(r, 16 // elem)
        if tc:
            sl = _round_up(max(ld, _round_up(r, 16)), 16)
        else:
            sl = _round_up(max(ld, _round_up(r, _K_TA)), 8) if f == 0 else _round_up(ld, 8)
        total += _K_SLOTS * sl * elem
    return _K_STAGES * total


def _chain_kernel_runs(n: int) -> bool:
    """Whether an order-``n`` unfolding runs the chain kernel (orders 4 to
    6; above, the chain of kernels 3 and 4)."""
    return 4 <= n <= _CHAIN_MAX_OPS + 1


def _sum_bytes(precision: str, dtype: str) -> int:
    """Bytes of one sum (Y entry, partial, value): 8 in f64 at ``fp32``, else 4."""
    return 8 if str(dtype) == "float64" and precision == "fp32" else 4


def _mega_cta_bytes(nw: int, r: int, ring: int, ev: int = 4) -> int:
    """Kernel 5's first-pass CTA of ``nw`` warps with ``ev``-byte sums (the
    partial, the held rows and U: 8 in f64; ``Smem`` in
    ``kron_scatter_ttm.cu``, whose held rows are padded by 8 floats or 2
    doubles)."""
    rp = _round_up(r, 16)
    col_tiles = _K_BLOCK_COLS // 8
    pad = 2 if ev == 8 else 8
    g_elems = (rp // 16) * (-(-col_tiles // nw)) * 128
    g = nw * ring
    y = g + nw * g_elems * ev
    u = y + nw * _K_DEPTH * (_K_BLOCK_COLS + pad) * ev
    ctl = u + nw * _K_DEPTH * (rp + pad) * ev
    return ctl + 2 * _K_WARPS * 4


def smem_bytes(cfg: BlockConfig, shape: Sequence[int], ranks: Sequence[int],
               precision: str = "fp32", dtype: str = "float32") -> int:
    """Shared memory of the busiest block this configuration launches: one
    warp's staging ring of kernel 1 (the launcher runs as many warps as fit,
    at least one) and, for the fused layout, kernel 5's CTA of one warp (it
    too shrinks its warps to fit). At orders 4 to 6 one warp's ring of the
    chain kernel (it too runs as many warps as fit); 0 above (kernels 3 and
    4 use none that depends on it)."""
    n = len(shape)
    if n > 3:
        if not _chain_kernel_runs(n):
            return 0
        return max(_chain_ring_bytes([ranks[t] for t in range(n - 1, -1, -1) if t != m],
                                     precision, dtype) for m in range(n))
    ring = max(_ring_bytes(*_operand_ranks(ranks, m), precision, dtype) for m in range(n))
    if cfg.layout == "fused":
        last = _ring_bytes(*_operand_ranks(ranks, n - 1), precision, dtype)
        return max(ring, _mega_cta_bytes(1, ranks[n - 1], last, _sum_bytes(precision, dtype)))
    return ring


def padded_slots(cfg: BlockConfig, shape: Sequence[int], nnz: int) -> int:
    """Modeled slots of the schedules of all modes, for uniform coordinates:
    each mode's ceil(I / bi) row-block groups, of which
    g = groups (1 - exp(-nnz / groups)) hold a nonzero, c = nnz / g each; a
    group is padded to a multiple of bn, one block when c < bn, else
    (bn - 1) / 2 slots on average."""
    nnz = max(0, int(nnz))
    total = 0.0
    for i in shape:
        groups = -(-int(i) // cfg.bi)
        g = groups * -math.expm1(-nnz / groups) if nnz else 0.0
        if g == 0.0:
            total += cfg.bn  # an empty tensor's schedule: one block of padding
        elif nnz / g < cfg.bn:
            total += g * cfg.bn
        else:
            total += nnz + g * (cfg.bn - 1) / 2
    return int(round(total))


def sweep_bytes(cfg: BlockConfig, shape: Sequence[int], ranks: Sequence[int], nnz: int,
                precision: str = "fp32", dtype: str = "float32") -> int:
    """Modeled bytes one sweep's unfoldings and core update move: every
    padded slot's coordinates, value and row read once a mode, each
    unfolding written, the last one read back by kernel 2 on the split
    layout, and the row split's boundaries. At orders 4 to 6 the chain
    kernel adds its partial rows, two (K,) rows and their row ids a range
    (``layout.chain_range_slots``: ``slots_per_part`` slots, fewer on a
    small tensor), written and read once; above order 6 the
    chained (slots, K) rows of kernels 3 and 4 are written and read. The
    fused layout writes no last unfolding; its partials take one (R, K)
    block per CTA (264 CTAs in f32, an H100's two a SM; 132 in f64, one a
    SM). Values, Y entries and partials take 8 bytes in f64 (at ``fp32``),
    4 otherwise."""
    n = len(shape)
    slots = padded_slots(cfg, shape, nnz) // n
    e = _sum_bytes(precision, dtype)
    total = 0
    for m in range(n):
        k = 1
        for t in range(n):
            if t != m:
                k *= int(ranks[t])
        per_slot = 4 * (n - 1) + e + 4  # coordinates, value, row
        total += slots * per_slot + 8 * (slots // max(1, cfg.slots_per_part) + 1)
        if _chain_kernel_runs(n):  # the partial rows: written by the ranges, read by the combine
            n_ranges = max(1, -(-slots // chain_range_slots(slots, max(1, cfg.slots_per_part))))
            total += 2 * (2 * n_ranges * k * e + 2 * n_ranges * 4)
        elif n > 3:  # the chain's rows: written by kron_contrib, read by scatter_rows
            total += 2 * slots * k * e
        if m == n - 1 and cfg.layout == "fused" and n <= 3:
            total += (264 if e == 4 else 132) * int(ranks[m]) * k * e
        else:
            total += int(shape[m]) * k * e
            if m == n - 1:
                total += int(shape[m]) * k * e  # kernel 2 reads it back
    return total


def _smem_limit(device) -> int:
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return H100_SMEM_PER_BLOCK_OPTIN
    props = torch.cuda.get_device_properties(dev)
    return int(getattr(props, "shared_memory_per_block_optin", H100_SMEM_PER_BLOCK_OPTIN))


def candidate_configs(shape: Sequence[int], ranks: Sequence[int], nnz: int, *,
                      precision: str = "fp32", device=None,
                      dtype: str = "float32") -> List[BlockConfig]:
    """The pruned, ranked candidate list, ``DEFAULT_CONFIG`` first. The
    fused layout is a candidate for 3-way tensors only, as in the
    reference (kernel 5 also serves 2-way ones; order >= 4 has no
    megakernel), in every dtype. Shared memory is sized for the dtype's
    staged elements and sums (f64: 8 bytes), so a fused CTA that does not
    fit is pruned here and never launched."""
    n = len(shape)
    limit = _smem_limit(device)
    default_slots = padded_slots(DEFAULT_CONFIG, shape, nnz)
    layouts = LAYOUTS if n == 3 else ("split",)
    cands = [BlockConfig(bn, bi, spp, layout)
             for layout in layouts for bn in (64, 128, 256) for bi in (64, 128, 256)
             for spp in (512, 1024, 2048)]
    kept = [c for c in cands
            if smem_bytes(c, shape, ranks, precision, dtype) <= limit
            and padded_slots(c, shape, nnz) <= SLOT_CACHE_GROWTH * default_slots]

    def rank(c: BlockConfig):
        # modeled bytes to three significant digits, then the fewest fields
        # changed from the default
        b = sweep_bytes(c, shape, ranks, nnz, precision, dtype)
        rounded = float(f"{b:.3g}")
        return rounded, sum(x != y for x, y in zip(c, DEFAULT_CONFIG))

    kept.sort(key=rank)
    return [DEFAULT_CONFIG] + [c for c in kept if c != DEFAULT_CONFIG]


# ---------------------------------------------------------------------------
# Persistent tuning table.
# ---------------------------------------------------------------------------


def default_table_path() -> str:
    env = os.environ.get(TABLE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "autotune.json")


class TuningTable:
    """On-disk JSON map fingerprint -> winning :class:`BlockConfig`.

    Writes are atomic (a temporary file and ``os.replace``), so concurrent
    processes never see a torn table; a missing, corrupt or other-version
    file reads as an empty table, never a crash."""

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else default_table_path()
        self._entries: Dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
            if data.get("version") == TABLE_VERSION:
                self._entries = dict(data.get("entries", {}))
        except (OSError, ValueError, AttributeError):
            self._entries = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, fp: str) -> bool:
        return fp in self._entries

    def get(self, fp: str) -> Optional[BlockConfig]:
        e = self._entries.get(fp)
        if e is None:
            return None
        c = e["config"]
        return BlockConfig(int(c["bn"]), int(c["bi"]), int(c["slots_per_part"]),
                           str(c["layout"]))

    def put(self, fp: str, cfg: BlockConfig, *, key: Optional[dict] = None,
            trial_ms: Optional[float] = None) -> None:
        self._entries[fp] = {"config": dict(cfg._asdict()), "key": key or {},
                             "trial_ms": trial_ms}

    def save(self) -> None:
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        payload = {"version": TABLE_VERSION, "entries": self._entries}
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


# ---------------------------------------------------------------------------
# Timed trials and the search.
# ---------------------------------------------------------------------------


def trial_nnz(nnz: int) -> int:
    """Nonzeros of the synthetic trial problem: the fingerprint's bucket,
    capped at ``TRIAL_NNZ_CAP``."""
    return min(nnz_bucket(nnz), TRIAL_NNZ_CAP)


def _synthetic_coo(shape: Sequence[int], nnz: int, dtype: str, device):
    """Uniform coordinates and values in [0.1, 10) from a seeded generator
    on ``device`` (duplicates allowed: a COO tensor sums them)."""
    from repro_torch.core.coo import SparseCOO

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.stack([torch.randint(0, int(s), (nnz,), generator=g, device=dev,
                                     dtype=torch.int32) for s in shape], dim=1)
    vals = (torch.rand(nnz, generator=g, device=dev) * 9.9 + 0.1).to(getattr(torch, dtype))
    return SparseCOO(idx, vals, tuple(int(s) for s in shape))


def trial_time_ms(cfg: BlockConfig, shape: Sequence[int], ranks: Sequence[int], nnz: int, *,
                  dtype: str = "float32", precision: str = "fp32", device="cuda",
                  repeats: int = 3, problem: Optional[dict] = None) -> float:
    """Best milliseconds of what ``cfg`` changes in a sweep, under ``cfg``,
    on a synthetic problem of :func:`trial_nnz` nonzeros: the N unfoldings
    and the core update with fixed factors (no factor update, which no
    configuration touches), after one warm-up run that builds the
    schedules. Timed with CUDA events on the card, the host clock on the
    CPU. ``problem`` (a dict) keeps the synthetic tensor and factors from
    one trial to the next of a search."""
    _count("trials")
    with _obs_span("autotune.trial", bn=cfg.bn, bi=cfg.bi, slots_per_part=cfg.slots_per_part,
                   layout=cfg.layout, nnz=trial_nnz(nnz)) as sp:
        ms = _trial_time_ms_body(cfg, shape, ranks, nnz, dtype=dtype, precision=precision,
                                 device=device, repeats=repeats,
                                 problem=problem if problem is not None else {})
        sp.set_attr("best_ms", ms)
        return ms


def _trial_time_ms_body(cfg, shape, ranks, nnz, *, dtype, precision, device, repeats,
                        problem) -> float:
    from repro_torch.core import hooi as _hooi
    from repro_torch.core.engine import make_engine

    dev = torch.device(device)
    if "coo" not in problem:
        problem["coo"] = _synthetic_coo(shape, trial_nnz(nnz), dtype, dev)
        problem["factors"] = _hooi.init_factors(shape, ranks, dtype=getattr(torch, dtype),
                                                device=dev)
    coo, fs = problem["coo"], problem["factors"]
    eng = make_engine("auto", dev, precision=precision)
    eng.apply_blocks(cfg)
    n = len(shape)

    def sweep():
        y = None
        for m in range(n):
            y = eng.mode_unfolding(coo, fs, m)
        return eng.core_update(coo, fs, y)

    sweep()  # builds the schedules
    best = float("inf")
    for _ in range(max(1, repeats)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sweep()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            sweep()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def autotune(shape: Sequence[int], ranks: Sequence[int], nnz: int, *,
             dtype: str = "float32", precision: str = "fp32", backend: Optional[str] = None,
             device="cuda", table: Optional[TuningTable] = None, max_trials: int = 4,
             force: bool = False) -> BlockConfig:
    """The tuned :class:`BlockConfig` for this problem on ``device``.

    Warm path: the fingerprint is in the table, so no search and no trial
    (``COUNTERS["table_hits"]`` counts it). Cold path (or ``force``): the
    first ``max_trials`` candidates are timed, the default among them; the
    fastest is saved to the table atomically and returned. A candidate
    whose trial raises loses and the search goes on (its ``autotune.trial``
    span records the error); after it, the device is synchronized, so a
    CUDA error is never swallowed but propagates from there."""
    dev = torch.device(device)
    if table is None:
        table = TuningTable()
    if backend is None:
        backend = backend_of(dev)
    fp = fingerprint(shape, ranks, nnz, dtype=dtype, precision=precision, backend=backend)
    if not force:
        hit = table.get(fp)
        if hit is not None:
            _count("table_hits")
            _obs_event("autotune.table_hit", fingerprint=fp)
            return hit
    _count("searches")
    problem: dict = {}
    with _obs_span("autotune.search", fingerprint=fp, max_trials=int(max_trials)) as sp:
        cands = candidate_configs(shape, ranks, nnz, precision=precision, device=dev,
                                  dtype=dtype)
        sp.set_attr("candidates", len(cands))
        cands = cands[: max(1, int(max_trials))]
        best_cfg, best_ms = DEFAULT_CONFIG, float("inf")
        for cfg in cands:
            try:
                ms = trial_time_ms(cfg, shape, ranks, nnz, dtype=dtype, precision=precision,
                                   device=dev, problem=problem)
            except Exception:  # an untunable candidate loses, never crashes the search
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)  # a sticky CUDA error propagates here
                continue
            if ms < best_ms:
                best_cfg, best_ms = cfg, ms
        sp.set_attr("layout", best_cfg.layout)
        sp.set_attr("best_ms", None if best_ms == float("inf") else best_ms)
    table.put(fp, best_cfg,
              key=_key(shape, ranks, nnz, dtype, precision, backend),
              trial_ms=None if best_ms == float("inf") else best_ms)
    table.save()
    return best_cfg
