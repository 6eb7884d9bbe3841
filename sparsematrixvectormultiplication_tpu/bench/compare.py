"""The SELL-C-σ operator against the other device SpMV paths, on one GPU.

    python -m sparsematrixvectormultiplication_tpu.bench.compare [--out FILE]

For ``fem_3d(60, 60, 60, dof=3)`` (50.8M nnz, long clustered rows),
``road_network(1_200_000)`` (short scattered rows) and
``webbase_like(1_000_000, 3)`` (power-law rows: the ELL rectangle, padded
to the longest row, is largest there) at f32,
bf16 values and f64, it runs the harness stages ``sell``, ``xla_csr``,
``xla_ell`` and ``cusparse_csr`` (:func:`.harness.run_matrix`) in forward
and then reverse order, each validated once with a seeded random ``x`` and
keeping its better time. The table goes to stdout with the card's name and
power limit. It exits non-zero if any stage fails or does not validate.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import jax

from ..models.synthetic import fem_3d, road_network, webbase_like
from ..utils.platform import enable_compile_cache, require_gpu
from .harness import BenchConfig, run_matrix

IMPLS = ("sell", "xla_csr", "xla_ell", "cusparse_csr")
MATRICES = {
    "fem3d": lambda: fem_3d(60, 60, 60, dof=3, seed=1),
    "road": lambda: road_network(1_200_000, seed=1),
    "webbase_like": lambda: webbase_like(1_000_000, 3, seed=9),
}


def compare_matrix(label, coo, dtypes, *, reps, rounds, log=print):
    """Rows of ``{matrix, dtype, impl, seconds, gflops, ...}`` and the
    list of stages that failed or did not validate."""
    rows, problems = [], []
    for dt in dtypes:
        cfg = BenchConfig(iterations=reps, rounds=rounds, dtype=dt,
                          kernels=("serial_csr",) + IMPLS + IMPLS[::-1],
                          flush_between_stages=True)
        res = run_matrix(label, coo, cfg, log=lambda m: None)
        problems += [f"{dt}: {p}" for p in res.problems()]
        if dt == dtypes[0] and "sell" in res.format_stats:
            st = res.format_stats["sell"]
            log(f"{label}: {res.nrows} rows, {res.nnz} nnz; SELL "
                f"c={st['slice_rows']} sigma={st['sigma']} bins "
                f"{[b['k'] for b in st['bins']]} padding "
                f"{st['padding_ratio']:.3f}")
        for name in IMPLS:
            s = res.stage(name)
            if s is None:
                continue
            lib = s.extra.get("cusparse")
            rows.append({"matrix": label, "dtype": dt, "impl": name,
                         "nnz": res.nnz, "seconds": s.seconds,
                         "gflops": s.gflops,
                         "sig_diffs": s.diff.significant_diffs,
                         "max_rel_err": s.diff.max_rel_err,
                         "device_bytes": s.extra.get("device_bytes"),
                         "cusparse": lib})
            log(f"  {dt:8s} {name:13s} {s.seconds * 1e6:10.1f} us "
                f"{s.gflops:8.1f} GF {s.extra['device_bytes'] / 1e6:8.1f} MB "
                f"sig_diffs={s.diff.significant_diffs} "
                f"max_rel={s.diff.max_rel_err:.2e}"
                + {True: "  (cuSPARSE)", False: "  (generic)"}.get(lib, ""))
    return rows, problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write JSON rows here")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    require_gpu("bench.compare")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_bcoo_cusparse_lowering", True)
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = jax.devices()[0]
    print(f"card: {card}; jax device_kind: {dev.device_kind}", flush=True)
    rows, problems = [], []
    for label, make in MATRICES.items():
        r, p = compare_matrix(label, make(),
                              ("float32", "bfloat16", "float64"),
                              reps=args.reps, rounds=args.rounds)
        rows += r
        problems += p
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "device_kind": dev.device_kind,
                       "rows": rows, "problems": problems}, f, indent=1)
    if problems:
        print("FAILED: " + "; ".join(problems), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
