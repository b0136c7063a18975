"""Batched design-point pricing — the *price* phase of the DSE pipeline.

The evaluation of one design point splits into two phases (see
:mod:`repro_torch.core.dse` for the pipeline view):

* **plan** — the discrete solves (TP sharding, PP min-max partition,
  intra-chip fusion DP, the (tp, pp, dp) × dim-assignment argmin). These are
  combinatorial, memo-cached in :mod:`repro_torch.core.memo`, and emit one
  :class:`PlanVector` per design point: a flat record of every numeric
  parameter the closed-form cost model needs.
* **price** — this module. All roofline / latency / utilization / cost /
  power terms (the Eq. 7 per-stage timing, the 1F1B iteration composition,
  the intra-chip derate and compute/memory/network breakdown, the §VI.C
  cost- and power-efficiency metrics) are *pure arithmetic* over stacked
  ``PlanVector`` columns, so one :func:`price_plans` call prices an entire
  design grid as array ops instead of Python scalar-by-scalar.

Backends
--------
``numpy``
    Stacked float64 columns, elementwise numpy ops — the reference.
``torch``
    The same formula run eagerly on float64 tensors on the engine's device
    (CPU or the CUDA card) through a torch ``xp`` shim
    (:mod:`repro_torch.kernels.pricing.ref`). Every eager op is its own
    correctly rounded IEEE operation, so it is **bit-identical** to numpy.
``kernel``
    The f64 CUDA kernel of :mod:`repro_torch.kernels.pricing` (one thread
    per candidate row, every operation pinned to IEEE round-to-nearest):
    **bit-identical** to numpy and hence to :func:`price_plan_scalar`; its
    ``certify()`` harness proves it row by row. A CPU device runs the
    kernel's plain PyTorch version instead.
``kernel-f32``
    The same kernel instantiated in float32 — the repo's only
    *approximate* backend. Outputs carry bounded relative drift, and every
    decision made from its columns goes through the drift-budget contract
    (:mod:`repro_torch.kernels.pricing.drift`): winners are re-priced
    exactly in f64 within the declared band, so selected candidates are
    provably identical to the scalar reference. Final winner pricing
    resolves to the exact reference backend (:func:`exact_backend`), so
    sweep outputs stay bit-identical end to end.
``auto``
    ``kernel``.

Every non-numpy backend runs on a ``device`` (``None``: the CUDA card,
which raises when there is none; pass ``device="cpu"`` for the plain
versions).

Because every formula is elementwise over the batch axis, pricing a batch
of one is bit-identical to pricing the point inside a batch of 80 — which
is what lets :meth:`DSEEngine.reprice_grid` price a grid in chunks while
staying certified against the serial path.

The certification itself lives in ``tests/test_torch_pricing.py``: every
exact backend reproduces :func:`price_plan_scalar` — a literal
transcription of the serial path's arithmetic in
``interchip._price_plan`` / ``dse._to_point`` / ``costpower`` — bit for
bit, and the phased sweep reproduces ``dse.sweep(phased=False)`` row for
row.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

BACKENDS = ("numpy", "torch", "kernel", "kernel-f32")

#: What ``"auto"`` resolves to: the hand-written kernel.
DEFAULT_BACKEND = "kernel"

#: Backends whose priced columns are approximate (bounded relative drift
#: instead of bit-identity). Decisions over these columns must go through
#: the drift-budget contract (``repro_torch.kernels.pricing.drift``), and
#: final winner pricing resolves to :func:`exact_backend`.
APPROX_BACKENDS = ("kernel-f32",)

#: Default relative drift band δ of the approximate backends' drift-budget
#: contract (``repro_torch.kernels.pricing.drift``). The pricing formula's
#: observed f32 drift on the seeded certification distribution is ≲ 4e-7
#: (a handful of ulps); 1e-5 leaves ~25× headroom while keeping the
#: re-priced band a sliver of the candidate mass.
DRIFT_BAND = 1e-5


@dataclasses.dataclass(frozen=True)
class PlanVector:
    """Numeric parameters of one planned design point (array-of-structs row).

    Emitted by the plan phase (``dse.plan_design_cells``); consumed in
    stacked column form by :func:`price_plans`. Every field is a float so
    the whole record stacks into a dense float64 matrix; integer quantities
    (tp, pp, n_micro, …) are exact in float64 far beyond any realistic
    system size.
    """

    # Eq. 7 critical-stage terms of the winning inter-chip plan
    t_comp_stage: float
    t_net_stage: float
    t_p2p: float
    t_dp: float                  # DP gradient all-reduce time (0 if dp == 1)
    n_micro: float
    tp: float
    pp: float
    # workload multipliers
    bwd_flop_mult: float
    bwd_comm_mult: float
    opt_mult: float              # optimizer bytes per parameter byte
    model_flops: float           # useful FLOPs per iteration
    weight_bytes: float          # total model weight bytes (unsharded)
    act_bytes_layer: float       # Σ tensor bytes of one unsharded layer
    layers_per_stage: float      # ceil(n_layers / pp)
    stage_layers: float          # max(1, ceil(n_layers / pp)) — derate denom
    # system constants
    n_chips: float
    chip_peak: float             # per-chip peak FLOP/s
    mem_capacity: float
    sys_peak_flops: float        # n_chips × chip_peak (system property)
    sys_price: float
    sys_power: float
    # intra-chip pass reductions (partition-summed, canonical np order)
    intra_comp: float
    intra_mem: float
    intra_net: float
    intra_total: float           # Σ per-partition critical time


FIELDS: tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(PlanVector))


def stack_plans(vectors: Sequence[PlanVector]) -> dict[str, np.ndarray]:
    """Array-of-structs → struct-of-arrays: one float64 column per field."""
    return {name: np.array([getattr(v, name) for v in vectors],
                           dtype=np.float64)
            for name in FIELDS}


#: Column order of :attr:`PlanMatrix.tags` rows.
TAG_FIELDS: tuple[str, ...] = ("tp", "pp", "dp", "assignment")


@dataclasses.dataclass(frozen=True)
class PlanMatrix:
    """Stacked *candidate-level* plan vectors (struct-of-arrays).

    One row per (tp, pp, dp) × dim-assignment candidate of an inter-chip
    search, emitted by ``interchip.candidate_matrix``. ``cols`` holds one
    float64 column per :class:`PlanVector` field; ``tags`` is an
    ``(n, 4)`` int64 array of the search coordinates (:data:`TAG_FIELDS`
    order — the dim-assignment entry indexes the candidate's position in
    the subdivision list of its (tp, pp, dp) combo). Feed ``cols``
    straight to :func:`price_plans`; the batched lexicographic argmin in
    ``interchip.select_plan`` consumes the resulting ``iter_time`` /
    ``per_chip_mem_bytes`` columns.
    """

    cols: Mapping[str, np.ndarray]
    tags: np.ndarray

    def __len__(self) -> int:
        return int(self.tags.shape[0])

    @classmethod
    def from_vectors(cls, vectors: Sequence[PlanVector],
                     tags: Sequence[tuple[int, int, int, int]]
                     ) -> "PlanMatrix":
        if len(vectors) != len(tags):
            raise ValueError(f"{len(vectors)} vectors vs {len(tags)} tags")
        return cls(stack_plans(vectors),
                   np.asarray(tags, dtype=np.int64).reshape(len(tags), 4))

    @staticmethod
    def concat(matrices: Sequence["PlanMatrix"]) -> "PlanMatrix":
        """Row-concatenate matrices (the engine's whole-grid pricing call)."""
        if not matrices:
            return PlanMatrix({name: np.empty(0) for name in FIELDS},
                              np.empty((0, 4), dtype=np.int64))
        return PlanMatrix(
            {name: np.concatenate([m.cols[name] for m in matrices])
             for name in FIELDS},
            np.concatenate([m.tags for m in matrices], axis=0))

    def take(self, rows: Sequence[int] | np.ndarray) -> "PlanMatrix":
        """Row-subset view (the pruning compaction: survivors only).

        ``rows`` are row indices into this matrix; the result's row ``i``
        is this matrix's row ``rows[i]``, tags included, so a pruned
        matrix stays a valid :class:`PlanMatrix` for every consumer
        (``price_plans``, the kernel path, IPC shipping).
        """
        idx = np.asarray(rows, dtype=np.int64)
        return PlanMatrix({name: col[idx] for name, col in self.cols.items()},
                          self.tags[idx])


def random_plan_vectors(n: int, seed: int = 0) -> list[PlanVector]:
    """Seeded random-but-plausible plan vectors, with every degenerate
    branch (no DP comm, no p2p, empty intra pass, inference-only
    multipliers) exercised at random.

    The single source of certification inputs: the seeded property tests
    (``tests/test_torch_pricing.py``) and the kernel harness
    (``repro_torch.kernels.pricing.certify``) both draw from here, so every
    backend is certified against the same input distribution.
    """
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tp = float(2 ** rng.integers(0, 7))
        pp = float(2 ** rng.integers(0, 5))
        n_layers = int(rng.integers(1, 130))
        lps = -(-n_layers // int(pp))  # ceil
        out.append(PlanVector(
            t_comp_stage=float(rng.uniform(1e-6, 1.0)),
            t_net_stage=float(rng.uniform(0.0, 1.0)),
            t_p2p=float(rng.choice([0.0, rng.uniform(0.0, 0.1)])),
            t_dp=float(rng.choice([0.0, rng.uniform(0.0, 0.5)])),
            n_micro=float(rng.integers(1, 1025)),
            tp=tp, pp=pp,
            bwd_flop_mult=float(rng.choice([0.0, 2.0])),
            bwd_comm_mult=float(rng.choice([0.0, 1.0])),
            opt_mult=float(rng.choice([0.0, 8.0])),
            model_flops=float(rng.uniform(1e12, 1e21)),
            weight_bytes=float(rng.uniform(1e6, 1e13)),
            act_bytes_layer=float(rng.uniform(1e3, 1e10)),
            layers_per_stage=float(lps),
            stage_layers=float(max(1, lps)),
            n_chips=float(2 ** rng.integers(0, 11)),
            chip_peak=float(rng.uniform(1e13, 1e16)),
            mem_capacity=float(rng.uniform(1e9, 1e12)),
            sys_peak_flops=float(rng.uniform(1e15, 1e19)),
            sys_price=float(rng.uniform(1e5, 1e9)),
            sys_power=float(rng.uniform(1e3, 1e7)),
            intra_comp=float(rng.choice([0.0, rng.uniform(0.0, 1.0)])),
            intra_mem=float(rng.choice([0.0, rng.uniform(0.0, 1.0)])),
            intra_net=float(rng.choice([0.0, rng.uniform(0.0, 1.0)])),
            intra_total=float(rng.choice([0.0, rng.uniform(1e-9, 1.0)]))))
    return out


def resolve_backend(backend: str) -> str:
    """Resolve ``"auto"`` to the concrete backend; validate the spelling."""
    if backend == "auto":
        return DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown pricing backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    return backend


def is_approx_backend(backend: str) -> bool:
    """True when the backend's priced columns carry bounded drift rather
    than bit-identity — selections over them must be drift-banded."""
    return resolve_backend(backend) in APPROX_BACKENDS


def exact_backend(backend: str) -> str:
    """The backend to price *final winners* on: approximate backends map
    to the numpy reference (so sweep outputs stay bit-identical end to
    end); exact backends price on themselves."""
    resolved = resolve_backend(backend)
    return "numpy" if resolved in APPROX_BACKENDS else resolved


# --- the pricing formula (generic over the array namespace) ------------------
# Operation ORDER here is load-bearing: it mirrors the serial scalar path
# (interchip._price_plan → dse._to_point → costpower.*_efficiency) expression
# by expression, which is what makes the batched result bit-identical to the
# reference. Don't re-associate products or fold constants.
def _price(xp, v: Mapping[str, object]) -> dict[str, object]:
    # Eq. 7 forward stage time + 1F1B backward composition
    t_fwd = xp.maximum(xp.maximum(v["t_comp_stage"], v["t_net_stage"]),
                       v["t_p2p"])
    t_bwd_comp = v["t_comp_stage"] * v["bwd_flop_mult"]
    t_bwd_net = v["t_net_stage"] * (v["bwd_flop_mult"] * v["bwd_comm_mult"])
    t_bwd = xp.maximum(xp.maximum(t_bwd_comp, t_bwd_net), v["t_p2p"])
    t_pipe = (v["n_micro"] + v["pp"] - 1.0) * (t_fwd + t_bwd)
    exposed_dp = xp.maximum(0.0, v["t_dp"] - v["n_micro"] * t_bwd_comp * 0.5)
    iter_time = t_pipe + exposed_dp
    util_inter = v["model_flops"] / (iter_time * v["n_chips"] * v["chip_peak"])

    # per-chip memory footprint + capacity check
    w_bytes = v["weight_bytes"] / (v["tp"] * v["pp"])
    opt_bytes = w_bytes * v["opt_mult"]
    act_per_layer = v["act_bytes_layer"] / v["tp"]
    act_bytes = (act_per_layer * v["layers_per_stage"]
                 * xp.minimum(v["n_micro"], v["pp"]))
    mem = w_bytes + opt_bytes + act_bytes
    feasible = mem <= v["mem_capacity"]

    # memory-bound derate from the intra-chip pass (dse._to_point)
    derate_on = (v["intra_total"] > 0) & (t_fwd > 0)
    safe_intra = xp.where(derate_on, v["intra_total"], 1.0)
    per_layer_inter = (xp.maximum(v["t_comp_stage"], v["t_net_stage"])
                       / v["stage_layers"])
    derate = xp.minimum(1.0, per_layer_inter / safe_intra)
    utilization = xp.where(derate_on, util_inter * derate, util_inter)

    # compute/memory/network latency breakdown
    total = v["intra_comp"] + v["intra_mem"] + v["intra_net"]
    nz = total != 0.0
    safe_total = xp.where(nz, total, 1.0)
    zero = total * 0.0
    frac_compute = xp.where(nz, v["intra_comp"] / safe_total, zero)
    frac_memory = xp.where(nz, v["intra_mem"] / safe_total, zero)
    frac_network = xp.where(nz, v["intra_net"] / safe_total, zero)

    # §VI.C efficiency metrics
    cost_eff = utilization * v["sys_peak_flops"] / v["sys_price"]
    power_eff = utilization * v["sys_peak_flops"] / v["sys_power"]

    return {
        "utilization": utilization,
        "cost_eff": cost_eff,
        "power_eff": power_eff,
        "frac_compute": frac_compute,
        "frac_memory": frac_memory,
        "frac_network": frac_network,
        "iter_time": iter_time,
        "util_inter": util_inter,
        "per_chip_mem_bytes": mem,
        "feasible": feasible,
    }


# --- the selection prepass (candidate pruning inputs) ------------------------
def _selection(xp, v: Mapping[str, object]) -> dict[str, object]:
    """The two columns the candidate argmin consumes — ``iter_time`` and
    ``per_chip_mem_bytes`` — plus the lower bounds the dominance filter
    uses, at a fraction of :func:`_price`'s work (no utilization, derate,
    breakdown or efficiency terms).

    The ``iter_time``/``per_chip_mem_bytes`` expressions are copied from
    :func:`_price` operation for operation, so prepass values are
    BIT-IDENTICAL to the priced columns — that is what lets the pruning
    stage reason about rows it will never fully price.

    ``iter_lb`` is the full pipeline term ``t_pipe`` (compute, network
    and p2p composed exactly as priced), dropping only the non-negative
    exposed-DP term: ``iter_lb ≤ iter_time`` always, with equality
    whenever the DP all-reduce hides. Because ``t_pipe`` is bounded
    below by its communication component
    ``(n_micro + pp - 1) · (t_net_fwd + t_net_bwd)`` — TP collective
    seconds, which grow monotonically with the TP degree (same payload,
    more chips in the group, fewer FLOPs to hide it) — the bound rises
    along the TP axis of the candidate enumeration, which is what lets
    the dominance filter sink whole swaths of high-TP candidates once
    any cheaper candidate is known.
    """
    t_fwd = xp.maximum(xp.maximum(v["t_comp_stage"], v["t_net_stage"]),
                       v["t_p2p"])
    t_bwd_comp = v["t_comp_stage"] * v["bwd_flop_mult"]
    t_bwd_net = v["t_net_stage"] * (v["bwd_flop_mult"] * v["bwd_comm_mult"])
    t_bwd = xp.maximum(xp.maximum(t_bwd_comp, t_bwd_net), v["t_p2p"])
    t_pipe = (v["n_micro"] + v["pp"] - 1.0) * (t_fwd + t_bwd)
    exposed_dp = xp.maximum(0.0, v["t_dp"] - v["n_micro"] * t_bwd_comp * 0.5)
    iter_time = t_pipe + exposed_dp

    w_bytes = v["weight_bytes"] / (v["tp"] * v["pp"])
    opt_bytes = w_bytes * v["opt_mult"]
    act_per_layer = v["act_bytes_layer"] / v["tp"]
    act_bytes = (act_per_layer * v["layers_per_stage"]
                 * xp.minimum(v["n_micro"], v["pp"]))
    mem = w_bytes + opt_bytes + act_bytes
    return {
        "iter_time": iter_time,
        "per_chip_mem_bytes": mem,
        "iter_lb": t_pipe,
    }


def selection_columns(cols: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Numpy selection prepass over stacked candidate columns.

    Always runs on the numpy reference: pruning is part of the *reference
    semantics* (which rows exist to be priced), so its decision procedure
    never floats with the pricing backend. Returns ``iter_time`` and
    ``per_chip_mem_bytes`` bit-identical to :func:`price_plans` output,
    plus the ``iter_lb`` dominance bound.
    """
    return {k: np.asarray(a) for k, a in _selection(np, cols).items()}


def _dispatch(formula, cols: Mapping[str, np.ndarray], backend: str,
              device) -> dict[str, np.ndarray]:
    """Run an elementwise batch formula on the chosen backend.

    ``formula(xp, row_or_cols)`` must be pure elementwise arithmetic over
    the batch axis — that is what makes every exact backend bit-identical
    to numpy, and a batch of one identical to the same point inside a batch
    of 80. The kernel backends know two formulas, :func:`_price` and
    :func:`_roofline`; any other raises.
    """
    backend = resolve_backend(backend)
    n = len(next(iter(cols.values()))) if cols else 0
    if n == 0 or backend == "numpy":
        out = formula(np, cols)
    else:
        from ..device import resolve_device

        dev = resolve_device(device)
        if backend == "torch":
            from ..kernels.pricing.ref import torch_columns

            out = torch_columns(formula, cols, dev)
        else:
            from ..kernels.pricing.ops import kernel_columns

            entry = {_price: "price", _roofline: "roofline"}.get(formula)
            if entry is None:
                raise ValueError(f"the pricing kernel has no entry for "
                                 f"formula {formula!r}")
            out = kernel_columns(entry, cols, dev,
                                 f32=backend in APPROX_BACKENDS)
    return {k: np.asarray(a) for k, a in out.items()}


def price_plans(plans: Sequence[PlanVector] | Mapping[str, np.ndarray],
                backend: str = "auto",
                device=None) -> dict[str, np.ndarray]:
    """Price a batch of plan vectors; returns a dict of per-point columns.

    ``plans`` is either a sequence of :class:`PlanVector` or pre-stacked
    columns from :func:`stack_plans`. Output keys: ``utilization``,
    ``cost_eff``, ``power_eff``, ``frac_compute|memory|network``,
    ``iter_time``, ``util_inter``, ``per_chip_mem_bytes``, ``feasible``.
    ``device`` is where a non-numpy backend runs (``None``: the card).
    """
    cols = plans if isinstance(plans, Mapping) else stack_plans(plans)
    return _dispatch(_price, cols, backend, device)


def price_plan_scalar(v: PlanVector) -> dict[str, float]:
    """Reference scalar pricing — a literal transcription of the serial
    path's arithmetic (``interchip._price_plan`` + ``dse._to_point`` +
    ``costpower``). The batched backends are certified bit-identical to
    this in ``tests/test_torch_pricing.py``."""
    t_fwd = max(v.t_comp_stage, v.t_net_stage, v.t_p2p)
    t_bwd_comp = v.t_comp_stage * v.bwd_flop_mult
    t_bwd_net = v.t_net_stage * (v.bwd_flop_mult * v.bwd_comm_mult)
    t_bwd = max(t_bwd_comp, t_bwd_net, v.t_p2p)
    t_pipe = (v.n_micro + v.pp - 1.0) * (t_fwd + t_bwd)
    exposed_dp = max(0.0, v.t_dp - v.n_micro * t_bwd_comp * 0.5)
    iter_time = t_pipe + exposed_dp
    util_inter = v.model_flops / (iter_time * v.n_chips * v.chip_peak)

    w_bytes = v.weight_bytes / (v.tp * v.pp)
    opt_bytes = w_bytes * v.opt_mult
    act_per_layer = v.act_bytes_layer / v.tp
    act_bytes = act_per_layer * v.layers_per_stage * min(v.n_micro, v.pp)
    mem = w_bytes + opt_bytes + act_bytes

    util = util_inter
    if v.intra_total > 0 and t_fwd > 0:
        per_layer_inter = max(v.t_comp_stage, v.t_net_stage) / v.stage_layers
        derate = min(1.0, per_layer_inter / v.intra_total)
        util = util_inter * derate

    total = v.intra_comp + v.intra_mem + v.intra_net
    return {
        "utilization": util,
        "cost_eff": util * v.sys_peak_flops / v.sys_price,
        "power_eff": util * v.sys_peak_flops / v.sys_power,
        "frac_compute": v.intra_comp / total if total else 0.0,
        "frac_memory": v.intra_mem / total if total else 0.0,
        "frac_network": v.intra_net / total if total else 0.0,
        "iter_time": iter_time,
        "util_inter": util_inter,
        "per_chip_mem_bytes": mem,
        "feasible": mem <= v.mem_capacity,
    }


def decompose_iter_time(v: PlanVector) -> dict[str, float]:
    """Per-term decomposition of one plan's iteration time (seconds).

    Splits the :func:`price_plan_scalar` ``iter_time`` into additive terms —
    the validation loop compares each against its measured counterpart
    rather than only the end-to-end number:

    ``t_compute``
        arithmetic on the critical stage (steady pipeline rounds), scaled by
        the intra-chip pass's compute share;
    ``t_memory``
        the memory-bound share of the same busy time (0 when no intra-chip
        pass ran — the inter-chip model alone cannot see memory);
    ``t_collective``
        exposed communication: stage network/P2P time that the compute of a
        round cannot hide, the exposed DP all-reduce, and the intra-chip
        network share;
    ``t_bubble``
        the (pp − 1) pipeline fill/drain rounds.

    The decomposition is exact by construction and certified at runtime:
    the terms are attributed so that they sum to ``iter_time`` bit-for-bit
    up to float addition order, and this function raises if they drift
    beyond 1 part in 10⁹ — the decomposition can never silently disagree
    with the priced scalar.
    """
    t_fwd = max(v.t_comp_stage, v.t_net_stage, v.t_p2p)
    t_bwd_comp = v.t_comp_stage * v.bwd_flop_mult
    t_bwd_net = v.t_net_stage * (v.bwd_flop_mult * v.bwd_comm_mult)
    t_bwd = max(t_bwd_comp, t_bwd_net, v.t_p2p)
    exposed_dp = max(0.0, v.t_dp - v.n_micro * t_bwd_comp * 0.5)
    iter_time = (v.n_micro + v.pp - 1.0) * (t_fwd + t_bwd) + exposed_dp

    # steady rounds: compute is attributed first; whatever of the round it
    # cannot cover is exposed communication
    comp_round = min(v.t_comp_stage, t_fwd) + min(t_bwd_comp, t_bwd)
    net_round = (t_fwd + t_bwd) - comp_round
    busy = v.n_micro * comp_round
    t_bubble = (v.pp - 1.0) * (t_fwd + t_bwd)

    total_intra = v.intra_comp + v.intra_mem + v.intra_net
    if total_intra > 0.0:
        t_compute = busy * (v.intra_comp / total_intra)
        t_memory = busy * (v.intra_mem / total_intra)
        intra_net = busy * (v.intra_net / total_intra)
    else:
        t_compute, t_memory, intra_net = busy, 0.0, 0.0
    t_collective = v.n_micro * net_round + exposed_dp + intra_net

    out = {
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_collective": t_collective,
        "t_bubble": t_bubble,
        "iter_time": iter_time,
    }
    resum = t_compute + t_memory + t_collective + t_bubble
    if abs(resum - iter_time) > 1e-9 * max(iter_time, 1e-300):
        raise AssertionError(
            f"iter-time decomposition drifted: terms sum to {resum!r}, "
            f"priced iter_time is {iter_time!r}")
    return out


# --- batched roofline (Fig 18 / dry-run terms over many cells) ---------------
def _roofline(xp, c: Mapping[str, object]) -> dict[str, object]:
    t_compute = c["hlo_flops"] / (c["chips"] * c["peak_flops"])
    t_memory = c["hlo_bytes"] / (c["chips"] * c["hbm_bw"])
    t_collective = c["collective_bytes"] / (c["chips"] * c["link_bw"])
    t_bound = xp.maximum(xp.maximum(t_compute, t_memory), t_collective)
    zero = t_bound * 0.0
    denom = t_bound * c["chips"] * c["peak_flops"]
    safe_denom = xp.where(denom != 0.0, denom, 1.0)
    frac = xp.where(denom != 0.0, c["model_flops"] / safe_denom, zero)
    nz_flops = c["hlo_flops"] != 0.0
    safe_flops = xp.where(nz_flops, c["hlo_flops"], 1.0)
    useful = xp.where(nz_flops, c["model_flops"] / safe_flops, zero)
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_collective, "t_bound": t_bound,
            "roofline_fraction": frac, "useful_flop_ratio": useful}


def batched_roofline(cols: Mapping[str, np.ndarray],
                     backend: str = "auto",
                     device=None) -> dict[str, np.ndarray]:
    """Batched roofline terms (the Fig 18 / dry-run terms) over many cells.

    ``cols`` holds stacked float64 columns ``hlo_flops``, ``hlo_bytes``,
    ``collective_bytes``, ``chips``, ``model_flops``, ``peak_flops``,
    ``hbm_bw``, ``link_bw``. Returns the per-cell time terms, bound,
    roofline fraction and useful-FLOP ratio — element-identical to the
    reference package's scalar ``RooflineTerms`` properties.
    """
    return _dispatch(_roofline, cols, backend, device)
