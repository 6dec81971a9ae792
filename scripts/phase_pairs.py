#!/usr/bin/env python3
"""Run phases of ``chip_smoke.py`` from two checkouts in turns on the card.

Compares a base checkout (``--base``, e.g. the parent commit unpacked with
``git archive``) with this one on the same card in one call: for each
round of ``--order`` (default ``base,head,head,base``) a fresh Python
process per checkout builds that checkout's kernel library, imports its
``chip_smoke.py`` and runs the named phases, in the same order every
time:

* ``train`` — ``phase_train()`` (the smoke parity steps, then unionlm-100m
  through ``launch.train.main``, two profiled steps and the restart);
* ``lm`` — ``phase_lm`` for every ``LM_ARCHS`` entry, then
  ``phase_lm_cli()``;
* ``lm-families`` — ``phase_lm_family`` for every ``FAMILY_ARCHS`` entry
  of that checkout, then ``phase_lm_cli("zamba2-7b")``;
* ``train-families`` — ``phase_train_families()`` (``[train-families]``),
  where the checkout has it;
* ``model-sharding`` — ``phase_model_sharding()``, where the checkout has
  it;
* ``dryrun``, ``audits`` — ``phase_dryrun()`` and ``phase_audits()``,
  where the checkout has them.

Each process writes its phases' full output and wall seconds to
``<out>/<round>-<label>.json`` (``--out``, default ``build/phase_pairs``)
and its log beside it; the summary (wall seconds per phase and the
numbers each phase is read for) is printed as one JSON object at the
end::

    git archive <parent> | tar x -C build/parent
    python3 scripts/phase_pairs.py --base build/parent \\
        --phases train,lm-families

Needs one NVIDIA card and ``nvcc``; the checkouts' ``chip_smoke.py`` must
pass on it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the code each process runs inside a checkout (its working directory)
_CHILD = r"""
import json, sys, time
sys.path.insert(0, "src")
import torch
import chip_smoke as c
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build()
build.load()
phases, out_path = sys.argv[1].split(","), sys.argv[2]
res = {"card": c._card_line()}
for ph in phases:
    t0 = time.perf_counter()
    if ph == "train":
        got = c.phase_train()
    elif ph == "lm":
        got = {a: c.phase_lm(a) for a in c.LM_ARCHS}
        got["smoke_cli"] = c.phase_lm_cli()
    elif ph == "lm-families":
        got = {a: c.phase_lm_family(a, n, k) for a, n, k in c.FAMILY_ARCHS}
        got["smoke_cli"] = c.phase_lm_cli("zamba2-7b")
    elif ph == "train-families":
        if not hasattr(c, "phase_train_families"):
            continue
        got = c.phase_train_families()
    elif ph == "model-sharding":
        if not hasattr(c, "phase_model_sharding"):
            continue
        got = c.phase_model_sharding()
    elif ph in ("dryrun", "audits"):
        if not hasattr(c, "phase_" + ph):
            continue
        got = getattr(c, "phase_" + ph)()
    else:
        raise SystemExit(f"unknown phase {ph}")
    res[ph] = {"wall_s": time.perf_counter() - t0, "out": got}
with open(out_path, "w") as f:
    json.dump(res, f, default=str)
print("OK", flush=True)
"""


def _summary(res: dict) -> dict:
    """The numbers each phase is read for."""
    out = {}
    if "train" in res:
        t = res["train"]["out"]
        out["train"] = {
            "wall_s": res["train"]["wall_s"],
            "parity_s": t.get("parity_s"),
            "steady_step_ms": t.get("steady_step_ms"),
            "steady_tokens_per_s": t.get("steady_tokens_per_s"),
            "profile": {k: v for k, v in t.get("profile", {}).items()
                        if not isinstance(v, (list, dict))}}
    for ph in ("lm", "lm-families"):
        if ph not in res:
            continue
        out[ph] = {"wall_s": res[ph]["wall_s"]}
        for a, r in res[ph]["out"].items():
            if a == "smoke_cli" or not isinstance(r, dict):
                continue
            sl = r.get("serve_lm", {})
            out[ph][a] = {
                "wall_s": r.get("wall_s"),
                "steps_per_s": sl.get("steps_per_s"),
                "tokens_per_s": sl.get("tokens_per_s"),
                "b4_launches_per_step": sl.get(
                    "b4_launches_per_step", r.get("b4_launches_per_step"))}
    for ph in ("dryrun", "audits"):
        if ph in res:
            out[ph] = {"wall_s": res[ph]["wall_s"], "out": res[ph]["out"]}
    if "model-sharding" in res:
        out["model-sharding"] = res["model-sharding"]["out"]
    if "train-families" in res:
        fam = res["train-families"]["out"]
        out["train-families"] = {"wall_s": res["train-families"]["wall_s"]}
        for a, r in fam.items():
            out["train-families"][a] = {
                k: r.get(k) for k in (
                    "reduced", "n_params", "steady_tokens_per_s",
                    "steady_step_ms", "peak_mem_bytes", "loss_first",
                    "loss_last", "wall_s")}
            out["train-families"][a]["profile"] = {
                k: v for k, v in r.get("profile", {}).items()
                if not isinstance(v, (list, dict))}
            out["train-families"][a]["probe_pick"] = r.get(
                "launches", {}).get("probe_pick")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="the other checkout (a directory)")
    ap.add_argument("--phases", default="train,lm-families")
    ap.add_argument("--order", default="base,head,head,base")
    ap.add_argument("--out", default="build/phase_pairs",
                    help="directory for each process's output, relative "
                         "to this checkout")
    ap.add_argument("--head-only", default="",
                    help="phases run once, after the others in the last "
                         "head process")
    args = ap.parse_args(argv)
    dirs = {"base": pathlib.Path(args.base).resolve(), "head": ROOT}
    outdir = ROOT / args.out
    outdir.mkdir(parents=True, exist_ok=True)
    summary, order = [], args.order.split(",")
    last_head = max(i for i, label in enumerate(order) if label == "head")
    for i, label in enumerate(order):
        phases = args.phases
        if i == last_head and args.head_only:
            phases = phases + "," + args.head_only
        path = outdir / f"{i}-{label}.json"
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(dirs[label] / "src"))
        proc = subprocess.run([sys.executable, "-c", _CHILD, phases,
                               str(path)], cwd=dirs[label], env=env,
                              capture_output=True, text=True)
        log = outdir / f"{i}-{label}.log"
        log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode != 0 or "OK" not in proc.stdout:
            print(f"{i} {label}: exit {proc.returncode}; "
                  f"{proc.stderr[-3000:]}", flush=True)
            return 1
        res = json.loads(path.read_text())
        row = {"round": i, "label": label, "card": res["card"],
               "process_s": time.perf_counter() - t0} | _summary(res)
        print(json.dumps(row), flush=True)
        summary.append(row)
    print(json.dumps({"phase_pairs": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
