"""Run the multi-device parts of ``chip_smoke.py`` alone on the card: phase
3's attention checks (decode attention with the context-parallel blocks
of CP_DECODE_CASES among them) and phase 20 (one NCCL rank training on
the (1, 1) mesh with FSDP, OLMoE-1B-7B on two gloo ranks sharing the card,
data-parallel steps on two). Each part's failure is printed and the next
still runs; the exit code is 1 if any failed.

    python3 tools/multi_device_phases.py          # from the root of a checkout
    python3 tools/multi_device_phases.py --nccl   # phase 20's two-rank parts
                                                  # alone over NCCL, a card a rank
    python3 tools/multi_device_phases.py --nccl jamba   # some of them: teardown,
                                                  # 20b, jamba, 20c
    python3 tools/multi_device_phases.py --jamba-floor   # one card: Jamba's 32
                                                  # layers in parts, kernel
                                                  # against plain scan

A few minutes, the kernels' build included: a quick way to iterate on
``parallel/`` and ``launch/`` without the other phases. ``--nccl`` needs
two cards or more: after two NCCL ranks have summed one tensor, it runs
(b), the Jamba comparison below, then (c), over NCCL, which reaches the
NCCL branches of the gather and the reduce-scatter (FSDP), as two gloo
ranks sharing one card do not; the children's logs are copied into
``chiprun_out/multi_device/``.
Then it serves jamba_v01_52b at its published depth (32 layers, about
104 GB of bf16 weights, more than one card holds) on two NCCL ranks, mesh
(1, 2): 16 experts 8 a rank, attention heads 16 / 4 a rank, SSM heads 64 a
rank, JAMBA_REQUESTS x JAMBA_PROMPT + JAMBA_NEW tokens greedy through
``ServeEngine`` (:func:`jamba_full_depth`), held against one card that
runs the same 32 layers in two parts of 16 (``init_params(blocks=...)``,
``forward_part``), the residual stream carried between them.
"""
from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: two NCCL ranks, a card each, sum one tensor (argv: rank, store directory)
PROBE = """
import sys, torch, torch.distributed as dist
from pathlib import Path
import chip_smoke as cs
rank = int(sys.argv[1])
dev = cs.phase20_join(Path(sys.argv[2]), "probe", rank, 2, "nccl")
x = torch.full((4,), rank + 1.0, device=dev)
dist.all_reduce(x)
dist.destroy_process_group()
print("sum", x.tolist(), "on", dev)
sys.exit(0 if x.tolist() == [3.0] * 4 else 1)
"""


#: the process-group teardown after model-axis collectives, in variants
#: (argv: rank, store directory, variant): eager collectives on the mesh's
#: 'model' group; an all-reduce on it captured in a CUDA graph that is alive
#: at the teardown; the same graph released first
TEARDOWN = """
import gc, sys, time, torch, torch.distributed as dist
from pathlib import Path
import chip_smoke as cs
from repro_torch.launch.mesh import parse_mesh
from repro_torch.parallel.dist import all_gather, all_reduce
rank, variant = int(sys.argv[1]), sys.argv[3]
dev = cs.phase20_join(Path(sys.argv[2]), "teardown-" + variant, rank, 2, "nccl")
mesh = parse_mesh("1x2", dev)
g = mesh.group("model")
x = torch.full((1024,), rank + 1.0, device=dev)
y = all_reduce(x, g)
z = all_gather(x, 0, g)
graph = None
if variant != "eager":
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        all_reduce(x, g)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        w = all_reduce(x, g)
    graph.replay()
    torch.cuda.synchronize()
    ok = w.tolist()[:2] == [3.0, 3.0]
    if variant == "graph-released":
        del graph, w
        gc.collect()
        torch.cuda.synchronize()
else:
    ok = True
ok = ok and y.tolist()[:2] == [3.0, 3.0] and z.shape[0] == 2048
t0 = time.perf_counter()
dist.destroy_process_group()
print(f"destroyed in {time.perf_counter() - t0:.2f} s; sums right: {ok}", flush=True)
sys.exit(0 if ok else 1)
"""
TEARDOWN_VARIANTS = ("eager", "graph-alive", "graph-released")


def teardown_probe(job_dir: Path) -> dict:
    """Each TEARDOWN variant on two NCCL ranks, a card each, killed past 45
    s: whether ``destroy_process_group`` returns."""
    import os
    import subprocess
    env = dict(os.environ, NCCL_DEBUG="WARN",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = {}
    for variant in TEARDOWN_VARIANTS:
        procs = [subprocess.Popen([sys.executable, "-u", "-c", TEARDOWN, str(r),
                                   str(job_dir), variant], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=45)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n[killed past 45 s]")
        out[variant] = [p.returncode for p in procs]
        print(f"[teardown {variant}] exit codes {out[variant]}\n"
              + "\n".join(f"  rank {r}: {x.strip()[-400:]}" for r, x in enumerate(logs)),
              flush=True)
    return out


def nccl_probe(job_dir: Path) -> bool:
    """Whether two NCCL ranks connect and sum within 90 s (NCCL's own log
    printed), before the parts that would wait on them much longer."""
    import os
    import subprocess
    env = dict(os.environ, NCCL_DEBUG="WARN",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    procs = [subprocess.Popen([sys.executable, "-c", PROBE, str(r), str(job_dir)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    ok = True
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=90)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
        ok = ok and p.returncode == 0
        print(f"[nccl probe rank {r}, exit {p.returncode}]\n{out[-3000:]}", flush=True)
    return ok


# ------------------------- jamba_v01_52b on two cards -------------------------
JAMBA_REQUESTS, JAMBA_PROMPT, JAMBA_NEW = 4, 2048, 32
#: a child of the comparison is killed past this many seconds
JAMBA_TIMEOUT_S = 240
#: the prompt positions whose prefill logits are held (every 256th, the last)
JAMBA_HELD = tuple(range(255, JAMBA_PROMPT, 256))


def jamba_cfg():
    from repro_torch.configs import get_config
    return get_config("jamba_v01_52b")


def jamba_prompts(torch, cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, cfg.vocab, (JAMBA_REQUESTS, JAMBA_PROMPT), generator=gen,
                         device=dev)


def jamba_reckoning(cfg, world: int = 2) -> dict:
    """Bytes a card of the weights, the cache, and the largest MoE
    activations of a prefill, from the shapes alone (meta tensors, rank 0's
    blocks), before the run: mesh (1, ``world``)."""
    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.shardings import param_shardings, shard_tree
    from repro_torch.models import init_cache, init_params
    from repro_torch.parallel.dist import Mesh
    from repro_torch.parallel.logical import use_rules
    from repro_torch.train.optimizer import tree_leaves

    def gb(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e9

    mesh = Mesh((1, world), ("data", "model"))
    whole = init_params(cfg, device="meta")
    with use_rules(make_axis_rules(mesh, cfg), mesh):
        cache = init_cache(cfg, JAMBA_REQUESTS, JAMBA_PROMPT + JAMBA_NEW, device="meta")
    t = JAMBA_REQUESTS * JAMBA_PROMPT
    cap = -(-t * cfg.moe_top_k * cfg.moe_capacity_factor // cfg.moe_experts)
    moe_act = 2 * (cfg.moe_experts // world) * int(cap) * (cfg.d_model + 3 * cfg.d_ff)
    return {"weights_gb_a_card": gb(shard_tree(whole, param_shardings(cfg, mesh), mesh)),
            "whole_weights_gb": gb(whole), "cache_gb_a_card": gb(cache),
            "moe_prefill_activations_gb": moe_act / 1e9,
            "logits_gb": JAMBA_REQUESTS * JAMBA_PROMPT * cfg.vocab / world * 2 / 1e9}


def prefill_routes_then(torch, prefill_routes: list, rows: int, store: list | None):
    """Route a prefill's MoE calls (any token count but ``rows``) to
    ``prefill_routes`` in call order (as :func:`chip_smoke.replayed_routes`);
    the decode steps' calls (``rows`` tokens) by their own router,
    recorded (sorted, on the host) into ``store`` unless it is None (a
    captured step reads nothing on the host)."""
    import contextlib

    from repro_torch.models import layers

    @contextlib.contextmanager
    def run():
        route, calls = layers._route, iter(prefill_routes)

        def routing(p, xt, k):
            probs, gates, idx = route(p, xt, k)
            if xt.shape[0] != rows:
                idx = next(calls).to(xt.device)
                gates = probs.gather(1, idx)
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            elif store is not None:
                store.append(idx.sort(dim=-1).values.cpu())
            return probs, gates, idx

        layers._route = routing
        try:
            yield
        finally:
            layers._route = route

    return run()


def jamba_parts(torch, job_dir: Path, stage: str) -> None:
    """One card: the 32 layers in two parts of 16 blocks' worth, each part's
    weights made on the card from the seed (``init_params(blocks=...)``),
    the residual stream carried between them, every route recorded. Stage
    "prefill": the prompts, the logits at JAMBA_HELD and the last position.
    Stage "prefill-plain": the same through the plain scan
    (``chip_smoke.plain_scan``), routed as "prefill" routed (its routes
    replayed): one card's own bf16 noise, which the two cards are held
    relative to, as phases 7 and 21 hold Mamba2. Stage "forced": the
    prompts and the two-card run's tokens, teacher-forced, the logits at
    every position a token was sampled from."""
    import contextlib

    import chip_smoke as cs
    from repro_torch.models import forward_part, init_params

    step = cs.phase20_progress(f"jamba {stage}", 0)
    dev = torch.device("cuda")
    cfg = jamba_cfg()
    tokens = jamba_prompts(torch, cfg, dev)
    if stage == "forced":
        gen = np.load(job_dir / "j_ranks.npz")["tokens"]          # (B, JAMBA_NEW)
        tokens = torch.cat([tokens, torch.from_numpy(gen[:, :-1]).to(dev)], 1)
    half = cfg.n_blocks // 2
    routes: list = []
    x = tokens
    t0 = time.perf_counter()
    if stage == "prefill-plain":
        with np.load(job_dir / "j_prefill.npz") as d:
            kernel_routes = [torch.from_numpy(d[f"route{i}"]) for i in range(cs.moe_layers(cfg))]
        routing = contextlib.ExitStack()
        routing.enter_context(cs.plain_scan())
        routing.enter_context(cs.replayed_routes(torch, kernel_routes))
    else:
        routing = cs.recorded_routes(routes)
    with torch.no_grad(), routing:
        for part, blocks in enumerate((range(half), range(half, cfg.n_blocks))):
            params = init_params(cfg, seed=cs.SEED, device=dev, blocks=blocks)
            step(f"part {part}: blocks {list(blocks)} made")
            x = forward_part(cfg, params, x, first=part == 0, last=part == 1)
            del params
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    at = list(JAMBA_HELD) + [JAMBA_PROMPT - 1] if stage != "forced" else \
        list(range(JAMBA_PROMPT - 1, JAMBA_PROMPT + JAMBA_NEW - 1))
    out = {"logits": x[:, at].float().cpu().numpy(),
           **{f"route{i}": r.numpy() for i, r in enumerate(routes)}}
    np.savez(job_dir / f"j_{stage}.npz", **out)
    cs.phase20_write(job_dir, f"j_{stage}", {
        "seconds": time.perf_counter() - t0,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "routes": len(routes)})


def jamba_rank(torch, job_dir: Path, rank: int, world: int) -> None:
    """One of two NCCL ranks, mesh (1, 2): this rank's blocks made leaf by
    leaf from the seed (``init_local_params``); an eager prefill with the
    one-card run's prefill routes replayed (the logits at JAMBA_HELD); the
    engine's generate twice, the prefill routed as the one-card run, the
    second timed (TTFT, TPOT, its tokens and the logits it sampled them
    from); then eager decode steps fed those tokens, their routes
    recorded."""
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_axis_rules, parse_mesh
    from repro_torch.launch.shardings import init_local_params
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.transformer import gather_vocab
    from repro_torch.parallel.logical import use_rules
    from repro_torch.serve import ServeEngine

    step = cs.phase20_progress("jamba ranks", rank)
    dev = cs.phase20_join(job_dir, "j", rank, world, "nccl")
    cfg = jamba_cfg()
    mesh = parse_mesh(f"1x{world}", dev)
    with np.load(job_dir / "j_prefill.npz") as d:
        pre = [torch.from_numpy(d[f"route{i}"]) for i in range(cs.moe_layers(cfg))]
    out: dict = {"rank": rank}
    max_len = JAMBA_PROMPT + JAMBA_NEW
    with use_rules(make_axis_rules(mesh, cfg), mesh), torch.no_grad():
        t0 = time.perf_counter()
        params = init_local_params(cfg, mesh, seed=cs.SEED, device=dev)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["weights_gib"] = torch.cuda.memory_allocated(dev) / 2**30
        step(f"weights made in {out['init_s']:.1f} s: {out['weights_gib']:.2f} GiB")
        prompts = jamba_prompts(torch, cfg, dev)
        with prefill_routes_then(torch, pre, JAMBA_REQUESTS, None):
            logits, _ = prefill(cfg, params, prompts, max_len=max_len)
            held = gather_vocab(cfg, logits[:, list(JAMBA_HELD) + [JAMBA_PROMPT - 1]])
        arrays = {"prefill": held.float().cpu().numpy()}
        del logits, held
        step("eager prefill done")
        engine = ServeEngine(cfg, params, max_batch=JAMBA_REQUESTS, max_len=max_len,
                             device=dev)
        with prefill_routes_then(torch, pre, JAMBA_REQUESTS, None):
            engine.generate(prompts, n_tokens=JAMBA_NEW)
        step(f"engine warm, {engine.captures} captured")
        sampled: list = []
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        with prefill_routes_then(torch, pre, JAMBA_REQUESTS, None), \
                cs.sampled_logits(sampled):
            res = engine.generate(prompts, n_tokens=JAMBA_NEW)
        out |= {"ttft_s": res.ttft, "tpot_s": res.tpot, "launches": kernels.launches(),
                "captures": engine.captures,
                "serving_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        step(f"engine timed: TTFT {res.ttft:.4f} s, TPOT {res.tpot:.5f} s")
        toks = torch.tensor(res.tokens, device=dev).t()              # (B, n)
        arrays["tokens"] = toks.cpu().numpy()
        arrays["engine"] = torch.stack([lg for lg, _ in sampled], 1).cpu().numpy()
        decode_routes: list = []
        with prefill_routes_then(torch, pre, JAMBA_REQUESTS, decode_routes):
            _, cache = prefill(cfg, params, prompts, max_len=max_len)
            for i in range(JAMBA_NEW - 1):
                decode_step(cfg, params, cache, toks[:, i], JAMBA_PROMPT + i)
        for i, r in enumerate(decode_routes):
            arrays[f"route{i}"] = r.numpy()
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        step("eager decode routes recorded")
    if rank == 0:
        np.savez(job_dir / "j_ranks.npz", **arrays)
    cs.phase20_write(job_dir, f"j_rank{rank}", out)
    engine.close()
    dist.destroy_process_group()


def jamba_full_depth(torch, job_dir: Path, card: str) -> dict:
    """jamba_v01_52b at 32 layers on two NCCL ranks against one card in
    two parts: the one card's prefill (its routes recorded), the two ranks
    (prefill routed as the one card's), the one card teacher-forced over
    the ranks' tokens. Holds, as phase 20(b) does: the prefill logits at
    JAMBA_HELD, and each sequence's sampled logits up to its first route
    difference between the two runs (and to its first token difference),
    within SSM_REL times one card's own plain-scan reading (at least
    SCALED_TOL_FULL: 28 of the 32 layers are Mamba2's, whose bf16 rounding
    grows with depth, phase 7); the ranks' launch counts."""
    import chip_smoke as cs

    cfg = jamba_cfg()
    reckon = jamba_reckoning(cfg)
    print(f"[jamba] {cfg.name}, {cfg.n_layers} layers (nothing cut), mesh (1, 2) "
          f"over NCCL on {card}: {json.dumps(reckon)}", flush=True)
    me = str(Path(__file__).resolve())
    floor = jamba_floor(torch, job_dir)
    cs.run_phase20_part("jranks", 2, job_dir, "nccl", script=me, timeout=JAMBA_TIMEOUT_S)
    cs.run_phase20_part("jforced", 1, job_dir, "nccl", script=me, timeout=JAMBA_TIMEOUT_S)
    ranks = [json.loads((job_dir / f"j_rank{r}.json").read_text()) for r in range(2)]
    parts = {k: json.loads((job_dir / f"j_{k}.json").read_text())
             for k in ("prefill", "forced")}
    with np.load(job_dir / "j_prefill.npz") as d:
        one_prefill = torch.from_numpy(d["logits"])
    with np.load(job_dir / "j_forced.npz") as d:
        forced = torch.from_numpy(d["logits"])
        forced_routes = [torch.from_numpy(d[f"route{i}"]) for i in range(cs.moe_layers(cfg))]
    with np.load(job_dir / "j_ranks.npz") as d:
        r = {k: torch.from_numpy(d[k]) for k in d.files}
    n_moe = cs.moe_layers(cfg)
    with np.load(job_dir / "j_prefill.npz") as d:
        pre_routes = [torch.from_numpy(d[f"route{i}"]) for i in range(n_moe)]
    rank_routes = pre_routes + [r[f"route{i}"] for i in range(n_moe * (JAMBA_NEW - 1))]
    first = cs.first_route_difference(torch, forced_routes, rank_routes, n_moe,
                                      JAMBA_REQUESTS)
    # sample i (the prefill's, then decode step i - 1's) is computed from
    # the routes of positions < JAMBA_PROMPT + i; each sequence is held up
    # to its first route difference and its first token difference
    upto = [min(JAMBA_NEW, max(1, f - JAMBA_PROMPT + 1)) for f in first]
    want = forced.argmax(-1)
    steps = []
    for b, k in enumerate(upto):
        diff = (r["tokens"][b] != want[b]).nonzero()
        steps.append(min(k, int(diff[0]) + 1 if diff.numel() else JAMBA_NEW))
    errs = [cs.scaled_err(r["engine"][b, :k], forced[b, :k]) for b, k in enumerate(steps)]
    limit = max(cs.SCALED_TOL_FULL, cs.SSM_REL * floor)
    out = {"card": card, "reckoning": reckon, "limit": limit,
           "one_card_plain_scan_scaled_err": floor,
           "prefill_scaled_err": cs.scaled_err(r["prefill"], one_prefill),
           "first_route_difference_positions": first, "steps_held": steps,
           "steps_before_route_difference": upto,
           "engine_scaled_err": max(errs),
           "ttft_s": [x["ttft_s"] for x in ranks], "tpot_s": [x["tpot_s"] for x in ranks],
           "weights_gib": [x["weights_gib"] for x in ranks],
           "serving_peak_gib": [x["serving_peak_gib"] for x in ranks],
           "peak_gib": [x["peak_gib"] for x in ranks], "init_s": [x["init_s"] for x in ranks],
           "captures": [x["captures"] for x in ranks],
           "launches_rank": [x["launches"] for x in ranks], "one_card": parts}
    print(f"    {json.dumps(out)}", flush=True)
    attn = cfg.n_layers // cfg.attn_every
    ssm = cfg.n_layers - attn
    for x in ranks:
        want_decode = attn * (JAMBA_NEW - 1)
        la = x["launches"]
        if not (la["decode_attention"] == want_decode and la["flash_attention"] == attn
                and la["ssd"] == ssm and la["rmsnorm_split_stat"] == ssm * JAMBA_NEW
                and la["rmsnorm_split_apply"] == ssm * JAMBA_NEW):
            raise AssertionError(f"jamba: launches {la}")
    if not (out["prefill_scaled_err"] <= limit and out["engine_scaled_err"] <= limit):
        raise AssertionError(f"jamba: two cards vs one card in parts {out}")
    return out


def jamba_floor(torch, job_dir: Path) -> float:
    """One card's prefill of the 32 layers in parts, through the kernel and
    through the plain scan with the kernel route's routes: the largest
    logit difference over the largest logit (one card's bf16 noise)."""
    import chip_smoke as cs
    me = str(Path(__file__).resolve())
    for part in ("jprefill", "jprefillplain"):
        cs.run_phase20_part(part, 1, job_dir, "nccl", script=me, timeout=JAMBA_TIMEOUT_S)
    with np.load(job_dir / "j_prefill.npz") as a, np.load(job_dir / "j_prefill-plain.npz") as b:
        floor = cs.scaled_err(torch.from_numpy(b["logits"]), torch.from_numpy(a["logits"]))
    print(f"[jamba] one card in two parts, plain scan against the kernel: "
          f"prefill logits within {floor:.4g} of the largest", flush=True)
    return floor


def child(part: str, job_dir: str, rank: int, world: int) -> int:
    """Entry of the comparison's children (``--phase20 PART DIR RANK WORLD
    BACKEND``)."""
    import faulthandler

    import torch

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    faulthandler.dump_traceback_later(JAMBA_TIMEOUT_S - 20)
    torch.backends.cuda.matmul.allow_tf32 = False
    job = Path(job_dir)
    if part == "jranks":
        jamba_rank(torch, job, rank, world)
    else:
        jamba_parts(torch, job, {"jprefill": "prefill", "jprefillplain": "prefill-plain",
                                 "jforced": "forced"}[part])
    return 0


def main() -> int:
    import torch

    nccl = sys.argv[1:2] == ["--nccl"]
    only = set(sys.argv[2:]) if nccl else set()      # --nccl [teardown 20b jamba 20c]
    floor_only = sys.argv[1:] == ["--jamba-floor"]
    if torch.cuda.device_count() < (2 if nccl else 1):
        print(f"needs {2 if nccl else 1} CUDA card(s)", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    card = cs.nvidia_smi("name,power.limit")
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    failed = []
    if floor_only:
        import tempfile
        parts = (("jamba_v01_52b's one-card noise", lambda: jamba_floor(
            torch, Path(tempfile.mkdtemp(prefix="jamba-floor-")))),)
    elif nccl:
        import tempfile
        job_dir = Path(tempfile.mkdtemp(prefix="phase20-nccl-"))
        if not nccl_probe(job_dir):
            print("two NCCL ranks did not sum; phase 20 over NCCL not run")
            return 1
        parts = tuple((name, run) for key, name, run in (
            ("teardown", "the process group's teardown", lambda: teardown_probe(job_dir)),
            ("20b", "phase 20b over NCCL", lambda: cs.phase20_b(torch, job_dir, "nccl")),
            ("jamba", "jamba_v01_52b at 32 layers on two cards",
             lambda: jamba_full_depth(torch, job_dir, card)),
            ("20c", "phase 20c over NCCL", lambda: cs.phase20_c(job_dir, "nccl")))
            if not only or key in only)
    else:
        parts = (("phase 3 attention", lambda: cs.check_kernels(torch, cs.Timer(torch))),
                 ("phase 20", lambda: cs.check_multi_device(torch, card)))
    for name, run in parts:
        t1 = time.perf_counter()
        out = None
        try:
            out = run()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        torch.cuda.empty_cache()
        print(f"{name} in {time.perf_counter() - t1:.1f} s", flush=True)
        if isinstance(out, dict) and any(out.get("graph-released", ())):
            print("the teardown hangs with the graph released too: the two-card "
                  "serving parts are not run", flush=True)
            failed.append(name)
            break
    if nccl:
        import shutil
        keep = ROOT / "chiprun_out" / "multi_device"
        keep.mkdir(parents=True, exist_ok=True)
        for f in list(job_dir.glob("*.log")) + list(job_dir.glob("*.json")):
            shutil.copy(f, keep / f.name)
    print(f"total {time.perf_counter() - t0:.1f} s; failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase20"]:
        part, job_dir, rank, world, _ = sys.argv[2:7]
        sys.exit(child(part, job_dir, int(rank), int(world)))
    sys.exit(main())
