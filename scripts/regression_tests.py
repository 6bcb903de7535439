#!/usr/bin/env python3
"""Run every example and capture logs (reference: scripts/regression_tests.py).

Each example's stdout goes to <out>/<name>.log; the '**Final Costs**' blocks
can then be diffed across runs with scripts/print_all_costs.py, exactly the
reference's partially-automated regression flow.
"""

import argparse
import os
import subprocess
import sys

EXAMPLES = [
    "minimal",
    "curve_fitting",
    "poisson_image_editing",
    "image_warping",
    "optical_flow",
    "intrinsic_image_decomposition",
    "volumetric_mesh_deformation",
    "arap_mesh_deformation",
    "cotangent_mesh_smoothing",
    "embedded_mesh_deformation",
    "robust_nonrigid_alignment",
    "shape_from_shading",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="regression_logs")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument(
        "--ceres",
        action="store_true",
        help="also run the independent scipy oracle in each example",
    )
    ap.add_argument(
        "--double",
        action="store_true",
        help="run every example in float64 (results_*_double.csv)",
    )
    ap.add_argument(
        "--converged",
        action="store_true",
        help="run Opt to convergence (meaningful oracle comparisons)",
    )
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for name in args.only or EXAMPLES:
        cmd = [sys.executable, "-u", os.path.join(root, "examples", f"{name}.py")]
        if args.small:
            cmd.append("--small")
        if args.cpu:
            cmd.append("--cpu")
        if args.ceres:
            cmd.append("--ceres")
        if args.converged:
            cmd.append("--converged")
        if args.double:
            cmd.append("--double")
        log = os.path.join(args.out, f"{name}.log")
        print(f"=== {name} ===", flush=True)
        with open(log, "w") as f:
            rc = subprocess.run(
                cmd, stdout=f, stderr=subprocess.STDOUT, cwd=root
            ).returncode
        tail = open(log).read().strip().splitlines()[-4:]
        print("\n".join("  " + l for l in tail))
        if rc != 0:
            failures.append(name)
            print(f"  FAILED (rc={rc}) — see {log}")
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("all examples passed")


if __name__ == "__main__":
    main()
