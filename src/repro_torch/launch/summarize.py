"""Summarize dry-run records into roofline tables.

The port's counterpart of the reference package's
``launch/summarize.py``, over ``launch.dryrun``'s records: the terms are
one rank's at the H100's peaks (``roofline``), and the memory column is
the rank's placed state (a card's peak allocation where one ran).

  python -m repro_torch.launch.summarize --out artifacts/dryrun_torch
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load(out_dir):
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt(v, digits=3):
    if v is None:
        return "-"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000 or abs(v) < 0.001:
            return f"{v:.2e}"
        return f"{v:.{digits}g}"
    return str(v)


def table(rows, mesh):
    from repro_torch.launch.roofline import PEAK_FLOPS
    out = []
    out.append("| arch | shape | compute_s | memory_s | coll_s | dominant | "
               "state GiB/rank | 6ND/counted | MFU-bound | note |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        tag = r.get("tag", "")
        name = r["arch"] + (f" [{tag}]" if tag else "")
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | - | - | - | FAIL | - | - | "
                       f"{r.get('error','')[:60]} |")
            continue
        t = r["terms_s"]
        mem = r.get("memory", {})
        held = mem.get("peak_bytes") or mem.get("argument_bytes")
        held_g = f"{held/2**30:.1f}" if held else "-"
        ur = r.get("useful_ratio")
        # MFU implied by the dominant term under perfect overlap:
        # model_flops / (chips * peak_flops * max(terms))
        mfu = "-"
        if r.get("model_flops") and max(t.values()) > 0:
            mfu = f"{r['model_flops'] / (r['chips'] * PEAK_FLOPS * max(t.values())):.1%}"
        out.append(
            f"| {name} | {r['shape']} | {fmt(t['compute_s'])} | "
            f"{fmt(t['memory_s'])} | {fmt(t['collective_s'])} | "
            f"{r['dominant'].replace('_s','')} | {held_g} | {fmt(ur)} | {mfu} | |")
    return "\n".join(out)


def skipped_cells():
    from repro_torch.configs import ARCH_NAMES, applicable_shapes, get_arch
    out = []
    for a in ARCH_NAMES:
        cfg = get_arch(a)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if s not in applicable_shapes(cfg):
                out.append((a, s, "pure full-attention arch: long_500k needs "
                            "a sub-quadratic path "
                            "(configs.base.applicable_shapes)"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    rows = load(args.out)
    for mesh in ("pod", "multipod"):
        n_ok = sum(1 for r in rows if r.get("mesh") == mesh and r.get("ok"))
        print(f"\n### Mesh `{mesh}` ({n_ok} cells OK)\n")
        print(table(rows, mesh))
    print("\n### Skipped cells (documented)\n")
    for a, s, why in skipped_cells():
        print(f"- `{a}` x `{s}`: {why}")


if __name__ == "__main__":
    main()
