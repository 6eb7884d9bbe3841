"""Render sweep CSVs into a RESULTS-style markdown table.

Usage:
    python -m sparsematrixvectormultiplication_tpu.bench.report result
"""

from __future__ import annotations

import csv
import os
import sys
from collections import defaultdict


def load_native(path: str):
    rows = defaultdict(dict)  # matrix -> stage -> row
    meta = {}
    with open(path) as f:
        for r in csv.DictReader(f):
            rows[r["matrix_name"]][r["stage"]] = r
            meta[r["matrix_name"]] = (int(r["rows"]), int(r["cols"]),
                                      int(r["nonzeros"]))
    return rows, meta


def fmt_gf(row):
    if not row:
        return "—"
    gf = float(row["gflops"])
    sig = int(row["significant_diffs"]) if row["significant_diffs"] else 0
    mark = "" if sig == 0 else f" ✗{sig}"
    return f"{gf:.2f}{mark}"


def _iter_native_rows(dirs):
    for d in dirs:
        path = os.path.join(d, "spmv_results.csv")
        if os.path.exists(path):
            with open(path) as f:
                for r in csv.DictReader(f):
                    if r.get("matrix_name"):
                        yield r


def best_table(dirs, out=None):
    """Consolidated best-per-matrix table across result dirs: the best
    validated f32 / bf16 / fp64 device stage per matrix with its share of
    the device's peak memory bandwidth — generated, never hand-edited."""
    best = defaultdict(dict)  # matrix -> class -> (gf, stage, row)
    meta = {}
    for r in _iter_native_rows(dirs):
        m = r["matrix_name"]
        stage = r["stage"]
        if stage.startswith("serial"):
            continue
        try:
            gf = float(r["gflops"])
            sig = int(r["significant_diffs"] or 0)
        except (ValueError, KeyError):
            continue
        if sig != 0 or gf <= 0:
            continue  # only validated rows may claim "best"
        cls = {"float64": "f64", "bfloat16": "bf16"}.get(r.get("dtype"), "f32")
        meta[m] = int(r["nonzeros"])
        if gf > best[m].get(cls, (0, "", None))[0]:
            best[m][cls] = (gf, stage, r)

    def pct(entry):
        p = entry[2].get("pct_peak_bw") if entry else None
        return f"{float(p):.0f}%" if p else ""

    def cell(e):
        return f"{e[0]:.2f} ({e[1]})" if e else "—"

    lines = [
        "| Matrix | nnz | best f32 (stage) | % peak BW | best bf16 | "
        "best f64 (stage) | % peak BW |",
        "|---|---|---|---|---|---|---|",
    ]
    for m in sorted(best, key=lambda m: -meta[m]):
        f32, bf, f64 = (best[m].get(k) for k in ("f32", "bf16", "f64"))
        lines.append(
            f"| {m} | {meta[m]/1e6:.1f}M | {cell(f32)} | {pct(f32)} "
            f"| {f'{bf[0]:.2f}' if bf else '—'} | {cell(f64)} | {pct(f64)} |")
    text = "\n".join(lines)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    return text


def main(argv=None):
    args = list(argv or sys.argv[1:])
    if args and args[0] == "--best":
        print(best_table(args[1:]))
        return
    out_dir = args[0] if args else "result"
    native = os.path.join(out_dir, "spmv_results.csv")
    rows, meta = load_native(native)
    stages = ["serial_csr", "serial_hll", "xla_csr", "xla_ell",
              "cusparse_csr", "sell", "sell_bf16", "sell_f64"]
    present = [s for s in stages
               if any(s in st for st in rows.values())]
    hdr = "| Matrix | nnz | " + " | ".join(present) + " |"
    sep = "|" + "---|" * (len(present) + 2)
    print(hdr)
    print(sep)
    for m in sorted(rows, key=lambda m: -meta[m][2]):
        nnz = meta[m][2]
        cells = " | ".join(fmt_gf(rows[m].get(s)) for s in present)
        print(f"| {m} | {nnz/1e6:.1f}M | {cells} |")
    print("\nGFLOPS = 2·nnz/t; ✗N marks N significant validation diffs "
          "(tolerances abs 1e-5 / rel 1e-4, ≙ reference main.c:145; fp64 "
          "stages within the round-off bound 2·k·eps·|A||x|).")


if __name__ == "__main__":
    main()
