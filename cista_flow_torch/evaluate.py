"""The quality harness: run an eval CLI of the port and hold its mean row
to targets.

    python -m cista_flow_torch.evaluate --model_mode cista-eiflow \\
        --path_to_test_data DATA/eval --test_data_mode upsampled \\
        --path_to_test_model gate/flagship_ft1_f16.npz --depth 1 --flow_iters 1 \\
        [--dtype bfloat16] [--device cpu] [--harness_mode with_flow|wo_flow|mvsec] \\
        [--targets gate/targets_sim_flagship_ft1.json --harness_tolerance 0.002] \\
        [--save_targets]

Counterpart of the JAX package's ``eval_harness.py``: the flags of the eval
CLIs (``config.add_args``; ``--model_mode`` defaults to cista-eiflow here),
and ``--harness_mode`` picks ``test_with_flow.evaluate_sequences`` (the
default), ``test_wo_flow.evaluate_sequences`` or ``test_mvsec.evaluate``
(MVSEC's HDF5 recordings; ``eval_harness.py:72-87``). With ``--targets`` the
mean row is held to the targets at ``--harness_tolerance`` (symmetric
relative deviation, denominators floored at 1e-3); the exit code is 1 if
any metric is off. With ``--save_targets`` the mean row is written to
``--targets`` instead, and the exit code is 0. ``evaluate_sequences`` and
``score`` are the with-flow eval's (``test_with_flow``).
"""
from __future__ import annotations

import argparse
import json
import sys

from . import config
from .test_with_flow import evaluate_sequences, score  # noqa: F401  (the gate replay's entry)


def mean_metrics(results, keys) -> dict:
    """The ``mean`` row as {metric: value}."""
    row = results[-1]
    assert row[0] == "mean"
    return {k: float(v) for k, v in zip(keys, row[1:1 + len(keys)])}


def compare(measured: dict, targets: dict, tolerance: float, atol: float = 1e-3):
    """(ok, lines): the symmetric relative deviation of each targeted
    metric, |measured - target| / max(|target|, atol), against
    ``tolerance``; ``atol`` keeps targets of exactly 0 (the outlier rates)
    from making the gate degenerate."""
    lines, ok = [], True
    for k, tv in targets.items():
        if k not in measured:
            lines.append(f"  {k}: target {tv} — MISSING from run")
            ok = False
            continue
        mv = measured[k]
        rel = abs(mv - tv) / max(abs(tv), atol)
        if rel > tolerance:
            ok = False
        lines.append(f"  {k}: measured {mv:.6f} vs target {tv:.6f} "
                     f"(rel dev {rel * 100:.2f}%) {'ok' if rel <= tolerance else 'FAIL'}")
    return ok, lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="quality harness of the PyTorch port")
    config.add_args(ap)
    ap.set_defaults(model_mode="cista-eiflow")
    ap.add_argument("--harness_mode", default="with_flow", choices=["with_flow", "wo_flow", "mvsec"])
    ap.add_argument("--targets", default=None, help="targets JSON ({metric: value})")
    ap.add_argument("--save_targets", action="store_true",
                    help="write the mean row to --targets and exit 0")
    ap.add_argument("--harness_tolerance", type=float, default=0.01)
    args = ap.parse_args(argv)
    if args.path_to_test_data is None:
        ap.error("--path_to_test_data is required")
    if args.save_targets and args.targets is None:
        ap.error("--save_targets needs --targets")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = config.from_args(args)
    if args.harness_mode == "with_flow":
        rows, keys, _ = evaluate_sequences(cfg, device=args.device)
    elif args.harness_mode == "wo_flow":
        from .test_wo_flow import evaluate_sequences as wo_flow
        rows, keys, _ = wo_flow(cfg, device=args.device)
    else:
        from .test_mvsec import evaluate as mvsec
        rows, keys, _ = mvsec(cfg, device=args.device)
    measured = mean_metrics(rows, keys)
    if args.save_targets:
        with open(args.targets, "w") as f:
            json.dump(measured, f, indent=2)
        print(f"wrote targets to {args.targets}: {measured}")
        return 0
    if args.targets is None:
        return 0
    with open(args.targets) as f:
        targets = json.load(f)
    ok, lines = compare(measured, targets, args.harness_tolerance)
    print(f"Quality gate (tolerance {args.harness_tolerance * 100:.1f}%):")
    print("\n".join(lines))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
