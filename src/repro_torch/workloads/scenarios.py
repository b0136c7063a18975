"""Named DSE scenarios — the paper's four workload families (§VI.C:
GPT3-1T, DLRM-793B, HPL-5M², FFT-1T) plus MoE, Mamba2 and serving/decode
sweeps as first-class scenarios.

Each scenario bundles a *picklable* workload builder (a module-level
function, so ``DSEEngine`` can ship it across process boundaries even under
spawn semantics) with the sweep grid the paper uses for that family, plus a
``smoke`` variant small enough for tests and CI: fewer chips per system, a
reduced grid, and a smaller model that still fits a 64-chip machine.

Consumed by ``benchmarks/bench_dse.py`` and ``examples/dse_scenario.py``:

    engine = DSEEngine()
    result = engine.sweep_scenario("llm", smoke=True)
    result.frontier   # Pareto-optimal systems (util × cost eff × power eff)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.mamba2_130m import CONFIG as MAMBA2_130M
from ..configs.mamba2_130m import SMOKE as MAMBA2_SMOKE
from ..configs.qwen3_moe_235b import CONFIG as QWEN3_MOE_235B
from ..configs.qwen3_moe_235b import SMOKE as QWEN3_MOE_SMOKE
from ..core.dse_engine import SweepSpec
from ..core.interchip import TrainWorkload
from ..models.config import ModelConfig
from ..systems.system import SystemSpec
from .dlrm import dlrm_workload
from .fft import fft_workload
from .hpl import hpl_workload
from .llm import (BYTES, GPT3_1T, GPT3_175B, LLAMA3_70B, LLAMA_68M, LLMShape,
                  decode_workload, gpt_workload, mamba_decode_workload,
                  mamba_workload)


def _shape_from_config(cfg) -> LLMShape:
    """Adapt a ``repro_torch.models.config.ModelConfig`` (the runtime's config
    record) to the graph builders' ``LLMShape``."""
    return LLMShape(name=cfg.name, n_layers=cfg.n_layers,
                    d_model=cfg.d_model, n_heads=cfg.n_heads,
                    n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                    vocab=cfg.vocab, d_head=cfg.head_dim,
                    moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k)


# --- module-level builders (picklable; signature: system -> TrainWorkload) ---
def llm_work(system: SystemSpec) -> TrainWorkload:
    return gpt_workload(GPT3_1T, global_batch=512, microbatch=1)


def llm_smoke_work(system: SystemSpec) -> TrainWorkload:
    # GPT3-1T cannot fit the smoke-sized machines; 175B reproduces the same
    # qualitative heat map at 64 chips.
    return gpt_workload(GPT3_175B, global_batch=512, microbatch=1)


def dlrm_work(system: SystemSpec) -> TrainWorkload:
    return dlrm_workload()


def hpl_work(system: SystemSpec) -> TrainWorkload:
    return hpl_workload()


def fft_work(system: SystemSpec) -> TrainWorkload:
    return fft_workload()


def moe_work(system: SystemSpec) -> TrainWorkload:
    return gpt_workload(_shape_from_config(QWEN3_MOE_235B),
                        global_batch=512, microbatch=1)


def moe_smoke_work(system: SystemSpec) -> TrainWorkload:
    return gpt_workload(_shape_from_config(QWEN3_MOE_SMOKE),
                        global_batch=64, microbatch=1)


def mamba2_work(system: SystemSpec) -> TrainWorkload:
    cfg = MAMBA2_130M
    return mamba_workload(_shape_from_config(cfg), global_batch=512,
                          microbatch=1, d_state=cfg.ssm_state,
                          expand=cfg.ssm_expand)


def mamba2_smoke_work(system: SystemSpec) -> TrainWorkload:
    cfg = MAMBA2_SMOKE
    return mamba_workload(_shape_from_config(cfg), global_batch=64,
                          microbatch=1, d_state=cfg.ssm_state,
                          expand=cfg.ssm_expand)


def serving_work(system: SystemSpec) -> TrainWorkload:
    # LLaMA3-70B decode: 32 requests per microbatch against an 8K KV cache
    return decode_workload(LLAMA3_70B, kv_len=8192, global_batch=512,
                           microbatch=32)


def serving_smoke_work(system: SystemSpec) -> TrainWorkload:
    return decode_workload(LLAMA_68M, kv_len=2048, global_batch=64,
                           microbatch=8)


# --- executable twins (the modeled-vs-measured bridge) -----------------------
@dataclasses.dataclass(frozen=True)
class ExecutableTwin:
    """The executable half of a validation pair.

    One twin fixes a runtime ``ModelConfig`` plus decode batch geometry such
    that a ``ServeEngine`` decode step over ``batch`` request slots with
    ``kv_len`` cache slots does, token for token, the work the analytical
    decode workload (:meth:`workload`) prices. The correspondence is not
    assumed: :meth:`assert_correspondence` recomputes FLOPs/token and KV
    bytes/request *closed-form from the config dims* and raises unless the
    workload's dataflow graphs agree — the two sides are maintained
    independently (graph builders vs runtime config), so this is the tripwire
    that keeps them from drifting apart.

    ``dense_experts`` mirrors the runtime's decode-time MoE semantics: at one
    token per request the engine runs every expert densely
    (the reference's ``models.layers.moe_dense`` — dropless, no dispatch), so the
    matched analytical graph prices all ``moe_experts`` experts, not
    ``moe_top_k``.
    """

    scenario: str
    cfg: ModelConfig
    batch: int                   # request slots per decode step
    kv_len: int                  # cache slots per request (engine max_len)
    prompt_len: int = 16         # measurement prompt (slots beyond it idle)
    dense_experts: bool = False  # decode-time MoE: all experts, densely
    wall_gate: bool = False      # big enough that wall-clock is compute/
                                 # memory-bound, not dispatch-bound

    def shape(self) -> LLMShape:
        """The graph builders' view of this twin (seq=1: one token/step)."""
        s = _shape_from_config(self.cfg)
        s = dataclasses.replace(s, seq=1, batch=self.batch)
        if self.dense_experts and s.moe_experts:
            s = dataclasses.replace(s, moe_top_k=s.moe_experts)
        return s

    def workload(self) -> TrainWorkload:
        """The matched analytical decode workload (one decode step per
        'iteration': ``global_batch == microbatch == batch``), including the
        embedding/LM-head blocks the executable step runs every token."""
        s = self.shape()
        if self.cfg.family == "ssm":
            return mamba_decode_workload(
                s, global_batch=self.batch, microbatch=self.batch,
                d_state=self.cfg.ssm_state, expand=self.cfg.ssm_expand,
                lm_head=True)
        return decode_workload(s, kv_len=self.kv_len,
                               global_batch=self.batch,
                               microbatch=self.batch, lm_head=True)

    # --- closed-form accounting (independent of the graph builders) --------
    def flops_per_token(self) -> float:
        """Forward FLOPs one decoded token costs, recomputed from the config
        dims alone (embedding + layers + LM head)."""
        cfg = self.cfg
        d = cfg.d_model
        if cfg.family == "ssm":
            d_in = cfg.ssm_expand * d
            n = cfg.ssm_state
            per_layer = (2.0 * d * (2 * d_in + 2 * n)      # in-proj
                         + 2.0 * d_in * cfg.ssm_conv       # causal conv
                         + 6.0 * d_in * n                  # SSD recurrence
                         + 3.0 * d_in                      # gate
                         + 2.0 * d_in * d)                 # out-proj
        else:
            q = cfg.n_heads * cfg.hd
            kv = cfg.n_kv_heads * cfg.hd
            per_layer = (2.0 * d * (q + 2 * kv)            # QKV
                         + 4.0 * self.kv_len * q           # QK^T + PV
                         + 2.0 * q * d)                    # out-proj
            if cfg.moe_experts:
                k_eff = cfg.moe_experts if self.dense_experts else cfg.moe_top_k
                per_layer += 2.0 * d * cfg.moe_experts     # router
                per_layer += 2.0 * k_eff * 3 * d * cfg.d_ff
            else:
                per_layer += 2.0 * 3 * d * cfg.d_ff        # gated MLP
        return cfg.n_layers * per_layer + 2.0 * d + 2.0 * d * cfg.vocab

    def kv_bytes_per_request(self) -> float:
        """Decode-state bytes one request holds per layer-stack pass: K+V
        cache slots (attention) or the SSD recurrent state + conv window
        (SSM; f32 state, bf16 conv window)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            d_in = cfg.ssm_expand * cfg.d_model
            state = d_in * cfg.ssm_state * 4.0
            conv = (cfg.ssm_conv - 1) * (d_in + 2 * cfg.ssm_state) * BYTES
            return cfg.n_layers * (state + conv)
        return (cfg.n_layers
                * 2.0 * self.kv_len * cfg.n_kv_heads * cfg.hd * BYTES)

    def assert_correspondence(self) -> dict:
        """Certify twin ↔ analytical-workload agreement; raise on drift.

        Returns the compared quantities (for reports/tests). FLOPs/token must
        agree exactly; KV bytes/request (attention families) likewise.
        """
        work = self.workload()
        g = work.layer_graph
        graph_flops = g.total_flops() * work.n_layers
        for blk in (work.pre_graph, work.post_graph):
            if blk is not None:
                graph_flops += blk.total_flops()
        graph_per_token = graph_flops / self.batch
        closed = self.flops_per_token()
        if abs(graph_per_token - closed) > 1e-6 * closed:
            raise AssertionError(
                f"twin {self.scenario!r}: FLOPs/token mismatch — graph "
                f"{graph_per_token:.6g} vs closed-form {closed:.6g}")
        out = {"flops_per_token": closed}
        if self.cfg.family != "ssm":
            attn = next(k for k in g.kernels if k.name == "AttnDec")
            graph_kv = attn.weight_bytes / self.batch * work.n_layers
            closed_kv = self.kv_bytes_per_request()
            if abs(graph_kv - closed_kv) > 1e-6 * closed_kv:
                raise AssertionError(
                    f"twin {self.scenario!r}: KV bytes/request mismatch — "
                    f"graph {graph_kv:.6g} vs closed-form {closed_kv:.6g}")
            out["kv_bytes_per_request"] = closed_kv
        return out


def _serving_twin() -> ExecutableTwin:
    # runtime mirror of workloads.llm.LLAMA_68M (the serving smoke shape)
    cfg = ModelConfig(name="llama_68m", family="dense", n_layers=2,
                      d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                      vocab=32000, param_dtype="bfloat16")
    return ExecutableTwin(scenario="serving", cfg=cfg, batch=8, kv_len=2048,
                          wall_gate=True)


def _moe_twin() -> ExecutableTwin:
    cfg = dataclasses.replace(QWEN3_MOE_SMOKE, param_dtype="bfloat16")
    return ExecutableTwin(scenario="moe", cfg=cfg, batch=8, kv_len=256,
                          dense_experts=True)


def _mamba2_twin() -> ExecutableTwin:
    cfg = dataclasses.replace(MAMBA2_SMOKE, param_dtype="bfloat16")
    return ExecutableTwin(scenario="mamba2", cfg=cfg, batch=8, kv_len=256)


_TWINS: dict[str, Callable[[], ExecutableTwin]] = {
    "serving": _serving_twin,
    "moe": _moe_twin,
    "mamba2": _mamba2_twin,
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One workload family's sweep: builder + grid + smoke variant."""

    name: str
    description: str
    work_fn: Callable[[SystemSpec], TrainWorkload]
    spec: SweepSpec
    smoke_work_fn: Callable[[SystemSpec], TrainWorkload] | None = None
    smoke_spec: SweepSpec | None = None

    def resolved(self, smoke: bool) -> "Scenario":
        """The scenario with its smoke variant promoted, if requested."""
        if not smoke:
            return self
        return dataclasses.replace(
            self, work_fn=self.smoke_work_fn or self.work_fn,
            spec=self.smoke_spec or self.spec,
            smoke_work_fn=None, smoke_spec=None)

    def executable_twin(self) -> ExecutableTwin:
        """The runtime twin of this scenario's smoke decode workload, with
        its modeled↔measured correspondence certified (raises on drift).
        Only the families the reference's execution layer can serve have
        twins."""
        try:
            build = _TWINS[self.name]
        except KeyError:
            raise NotImplementedError(
                f"scenario {self.name!r} has no executable twin; "
                f"available: {sorted(_TWINS)}") from None
        twin = build()
        twin.assert_correspondence()
        return twin


_SMOKE_GRID = dict(n_chips=64,
                   chips=("H100", "TPUv4", "SN30"),
                   topologies=("torus2d", "dragonfly"),
                   mem_net=(("DDR", "PCIe"), ("HBM", "PCIe"),
                            ("HBM", "NVLink")))

# HPL/FFT run one global problem instance (global_batch=1 ⇒ DP=1); the whole
# machine must be absorbed by TP (×PP), so TP is unbounded for those.
SCENARIOS: dict[str, Scenario] = {
    "llm": Scenario(
        name="llm",
        description="GPT3-1T training, global batch 512 (Figs 10-13)",
        work_fn=llm_work, spec=SweepSpec(max_tp=64),
        smoke_work_fn=llm_smoke_work,
        smoke_spec=SweepSpec(max_tp=64, **_SMOKE_GRID)),
    "dlrm": Scenario(
        name="dlrm",
        description="DLRM-793B recommendation training (Fig 14)",
        work_fn=dlrm_work, spec=SweepSpec(max_tp=64),
        smoke_spec=SweepSpec(max_tp=64, **_SMOKE_GRID)),
    "hpl": Scenario(
        name="hpl",
        description="HPL 5M×5M LINPACK (Fig 15)",
        work_fn=hpl_work, spec=SweepSpec(max_tp=None),
        smoke_spec=SweepSpec(max_tp=None, **_SMOKE_GRID)),
    "fft": Scenario(
        name="fft",
        description="1T-point distributed FFT (Figs 16-17)",
        work_fn=fft_work, spec=SweepSpec(max_tp=None),
        smoke_spec=SweepSpec(max_tp=None, **_SMOKE_GRID)),
    "moe": Scenario(
        name="moe",
        description="Qwen3-MoE-235B training (128 experts, top-8)",
        work_fn=moe_work, spec=SweepSpec(max_tp=64),
        smoke_work_fn=moe_smoke_work,
        smoke_spec=SweepSpec(max_tp=64, **_SMOKE_GRID)),
    "mamba2": Scenario(
        name="mamba2",
        description="Mamba2-130M SSD training (attention-free)",
        work_fn=mamba2_work, spec=SweepSpec(max_tp=64),
        smoke_work_fn=mamba2_smoke_work,
        smoke_spec=SweepSpec(max_tp=64, **_SMOKE_GRID)),
    "serving": Scenario(
        name="serving",
        description="LLaMA3-70B decode serving (batch 32, 8K KV cache)",
        work_fn=serving_work, spec=SweepSpec(max_tp=64),
        smoke_work_fn=serving_smoke_work,
        smoke_spec=SweepSpec(max_tp=64, **_SMOKE_GRID)),
}


def scenario_names() -> list[str]:
    return list(SCENARIOS)


def get_scenario(name: str, smoke: bool = False) -> Scenario:
    try:
        sc = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {scenario_names()}") from None
    return sc.resolved(smoke)
