"""Roofline report: dry-run JSONs -> markdown dry-run and roofline tables
(the port of ``src/repro/roofline/report.py``; the HBM column reads one
H100's 80 GB per device, and the mesh defaults to the dry-run's ``one``).
``main`` prints both tables for each mesh in the records (``one``,
``single``, ``multi``, ``tiny``, ``tiny_multi``: every figure per device)
and the hill-climb picks of each of ``single`` and ``multi`` (or of the
mesh it is given)."""
from __future__ import annotations

import glob
import json
import os


def load_records(dryrun_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            recs.extend(json.load(f))
    return recs


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def _fmt_b(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def dryrun_table(recs: list[dict], mesh: str | None = None) -> str:
    rows = ["| arch | shape | mesh | status | peak bytes/device "
            "(arg+tmp+out−alias) | fits 80GB | GFLOPs/dev | "
            "collective/dev | compile |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if mesh and r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"SKIP (sub-quadratic required) | — | — | — | — | — |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR | — | — | — | — | — |")
            continue
        m = r["memory"]
        total = r.get("peak_bytes",
                      m["argument_bytes"] + m["temp_bytes"]
                      + m["output_bytes"] - m.get("alias_bytes", 0))
        coll = sum(r["collective_bytes"].values())
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{_fmt_b(total)} ({_fmt_b(m['argument_bytes'])}+"
            f"{_fmt_b(m['temp_bytes'])}+{_fmt_b(m['output_bytes'])}"
            f"−{_fmt_b(m.get('alias_bytes', 0))}) | "
            f"{'yes' if r['fits_hbm'] else 'NO'} | "
            f"{r['cost']['flops_per_device']/1e9:.1f} | "
            f"{_fmt_b(coll)} | {r['compile_s']:.0f}s |")
    return "\n".join(rows)


def roofline_table(recs: list[dict], mesh: str = "one") -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "MODEL_FLOPS | useful frac | roofline frac | what would move the "
            "dominant term |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(ro['compute_s'])} | "
            f"{_fmt_s(ro['memory_s'])} | {_fmt_s(ro['collective_s'])} | "
            f"**{ro['dominant']}** | {ro['model_flops']:.2e} | "
            f"{ro['useful_flops_fraction']:.3f} | "
            f"{ro['roofline_fraction']:.3f} | {advice(r)} |")
    return "\n".join(rows)


def advice(r: dict) -> str:
    ro = r["roofline"]
    dom = ro["dominant"]
    kind = r["kind"]
    if dom == "memory" and kind == "decode":
        return ("decode reads the whole KV cache per token — quantize KV / "
                "batch more requests per read")
    if dom == "memory" and ro["useful_flops_fraction"] < 0.7:
        return ("remat recompute + microbatch weight re-reads dominate — "
                "fewer microbatches / selective remat policy")
    if dom == "memory":
        return "fuse residual/norm traffic; larger per-device batch"
    if dom == "collective":
        if r["collective_bytes"].get("all-gather", 0) > \
                r["collective_bytes"].get("all-reduce", 0):
            return ("FSDP weight all-gathers dominate — gather once per step "
                    "(not per microbatch) or widen TP")
        return ("TP activation all-reduces dominate — overlap with compute "
                "(latency-hiding scheduler) or reduce TP degree")
    return "already compute-bound: increase arithmetic intensity per chip"


def pick_hillclimb(recs: list[dict], mesh: str = "one") -> dict:
    """worst roofline fraction, most collective-bound, most representative."""
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == mesh
          and r["kind"] == "train"]
    ok_all = [r for r in recs if r["status"] == "ok"
              and r["mesh"] == mesh]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok_all, key=lambda r: r["roofline"]["collective_s"])
    return {"worst_fraction": (worst["arch"], worst["shape"]),
            "most_collective": (coll["arch"], coll["shape"])}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default=None,
                    help="one mesh's tables (default: every mesh found)")
    args = ap.parse_args(argv)
    recs = load_records(args.dryrun_dir)
    meshes = [args.mesh] if args.mesh else list(dict.fromkeys(
        r["mesh"] for r in recs))
    for mesh in meshes:
        print("## Dry-run table (%s)\n" % mesh)
        print(dryrun_table(recs, mesh))
        print("\n## Roofline table (%s)\n" % mesh)
        print(roofline_table(recs, mesh))
        print()
    for mesh in [m for m in meshes if m in ("single", "multi")] or meshes:
        print("hillclimb picks (%s):" % mesh, pick_hillclimb(recs, mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
