#!/usr/bin/env python3
"""Plant faults in a copy of the decode path and show which of
``chip_smoke.py``'s checks fails each of them: the phase-3 decode cases
(every case against the plain version within DECODE_REL and against the
f64 value within one bf16 ulp + DECODE_ULP_FLOOR, lse within 1e-3, and one
captured launch replayed at other kv_len) and phase 9's graph-vs-eager
check (minitron_4b at full width, MINITRON_LAYERS layers, 4 x 2048 prompt
tokens: the engine's captured decode step against ``decode_step`` called
eagerly, tokens identical over all NEW_TOKENS - 1 steps).

    python3 tools/decode_planted_faults.py      # from the root of a checkout

Needs a CUDA card and nvcc. For every run the script copies
``src/repro_torch`` into a temporary directory, edits the copy at anchors
that occur once (the checkout is never touched), builds the copies'
kernels in parallel and runs the checks in one process per run. The
unchanged source runs the same way as the baseline. Faults:

  dropped_split              the last block of every head group takes no
                             keys (its part of [0, kv_len) is dropped);
  kv_len_off_by_one          the kernel reads kv_len - 1 keys;
  p_rounded_to_bf16          P is rounded once to bf16 before P V;
  kv_len_frozen_at_capture   the engine writes the position only before it
                             captures the step, so every replay attends
                             over the captured kv_len and writes its K/V at
                             the captured position.

Prints one JSON line per run, with the checks that fired, and exits
non-zero if the baseline fails a check or a fault passes them all.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("repro_torch/kernels/decode_attention/csrc/decode_attention.cu")
ENGINE = Path("repro_torch/serve/engine.py")

# Anchors: text that occurs exactly once in its file
# (tests/test_torch_planted_faults.py holds them to that).
NTILES = "    return split < tiles ? (tiles - split + n_split - 1) / n_split : 0;"
LEN = "    kv_len = min(max(kv_in, 0), p.S);"
PV = "        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(pr[r], vf[e], acc[r][e]);"
POS = "        slot.pos.fill_(pos)\n"
ANCHORS = {KERNEL: (NTILES, LEN, PV), ENGINE: (POS,)}

#: name -> (file, edits as (anchor, replacement), what it does)
FAULTS = {
    "dropped_split": (KERNEL, [(NTILES, NTILES.replace(
        "split < tiles ?", "split < tiles && split != n_split - 1 ?"))],
        "the last block of every head group takes no keys"),
    "kv_len_off_by_one": (KERNEL, [(LEN, LEN.replace("max(kv_in,", "max(kv_in - 1,"))],
                          "the kernel reads kv_len - 1 keys"),
    "p_rounded_to_bf16": (KERNEL, [(PV, PV.replace(
        "fmaf(pr[r],", "fmaf(__bfloat162float(__float2bfloat16(pr[r])),"))],
        "P is rounded once to bf16 before P V"),
    "kv_len_frozen_at_capture": (ENGINE, [(POS, "        if slot.graph is None:\n"
                                                "            slot.pos.fill_(pos)\n")],
                                 "the position is written only before the capture"),
}


def plant(text: str, edits: list[tuple[str, str]]) -> str:
    """Replace each anchor, which must occur exactly once, by its edit."""
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"planted fault: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def run_case(src: Path) -> dict:
    """In a child process, on the package under ``src``: every phase-3
    decode case, then phase 9's graph-vs-eager check on minitron_4b."""
    sys.path[:0] = [str(src), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    phase3, worst = [], {"o_err": 0.0, "ulp_excess": 0.0, "lse_err": 0.0}
    for label, shape in chip_smoke.decode_cases():
        q, k, v = chip_smoke.decode_inputs(torch, g, shape)
        lens = (shape[-1],) + ((0, 1, 17, shape[3]) if label in chip_smoke.DECODE_REPLAYED
                               else ())
        for n in lens:
            try:
                if n == shape[-1]:
                    r = chip_smoke.decode_check(torch, q, k, v, n, *decode_attention(q, k, v, n),
                                                label)
                else:
                    r = chip_smoke.decode_replay_check(torch, decode_attention, q, k, v, (n,),
                                                       label)[n]
                for key in worst:
                    worst[key] = max(worst[key], r[key])
            except AssertionError as e:
                phase3.append(str(e)[:200])
    full = get_config("minitron_4b")
    cfg = dataclasses.replace(full, n_layers=chip_smoke.MINITRON_LAYERS)
    params, prompts = chip_smoke.serve_inputs(torch, cfg, chip_smoke.REQUESTS, chip_smoke.SEED)
    try:
        res, phase9 = chip_smoke.graph_vs_eager(torch, cfg, params, prompts), None
    except AssertionError as e:
        res, phase9 = None, str(e)[-300:]
    return {"phase3_failed": phase3, "phase3_worst_inside": worst,
            "phase9_failed": phase9, "phase9": res}


def build(src: Path) -> None:
    """Build the decode, RMSNorm and flash kernels of the copy at ``src``
    (into its own build directory)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import _build; "
            "[_build.load(n) for n in ('decode_attention', 'rmsnorm', 'flash_attention')]")
    subprocess.run([sys.executable, "-c", code, str(src)], check=True,
                   capture_output=True, text=True, timeout=900)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--case":
        print(json.dumps(run_case(Path(sys.argv[2]))), flush=True)
        return 0
    with tempfile.TemporaryDirectory(prefix="planted-decode-") as tmp:
        srcs = {}
        for name in ("baseline", *FAULTS):
            dst = Path(tmp) / name / "src" / "repro_torch"
            shutil.copytree(ROOT / "src" / "repro_torch", dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
            if name in FAULTS:
                path, edits, _ = FAULTS[name]
                f = dst.parent / path
                f.write_text(plant(f.read_text(), edits))
            srcs[name] = dst.parent
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(build, srcs.values()))
        ok = True
        for name, src in srcs.items():
            out = subprocess.run([sys.executable, __file__, "--case", str(src)],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            what = FAULTS[name][2] if name in FAULTS else "the unchanged source"
            caught = bool(res["phase3_failed"] or res["phase9_failed"])
            good = caught == (name in FAULTS)
            ok &= good
            print(json.dumps({"run": name, "what": what, "caught": caught,
                              "as_expected": good, **res}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
