"""The readings that a cell's limits are set from, on the card.

    python benchmark/calibrate.py --workload <cell> --calls N --seeds 1 2 ... \\
        [--control-seeds 1 2 3]

For each seed of ``--seeds``: the program serves ``--calls`` calls of the
cell's traffic in its closed loop (as many as a run's window holds), and
``check.compare`` reads its largest frame RMSE and flow EPE against the
plain reference. For each of ``--control-seeds``: the control, the
reference itself with every conv's and matmul's operands rounded through
float8 e4m3 under a per-tensor scale (``reference.ops.fp8_rounding``, the
next precision below the configuration's bf16), is read the same way
against the f32 reference over as many calls. One process, one program:
set-up is paid once. Prints one JSON line per reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    sys.path.insert(0, str(harness.ROOT))
    import torch

    import check
    import reference
    import traffic
    from reference.ops import fp8_rounding

    device = "cuda"
    cell, cfg, mix = harness.load_cell(args.workload)
    params = reference.load_params(str(harness.ROOT / cfg["weights"]), device)
    recon = harness.build_program(cfg, mix, device) if args.seeds else None
    for seed in args.seeds:
        pool = traffic.make_pool(seed, mix, device)
        recon.reset()
        call = harness.port_call(recon, cell["entry"], mix["streams"])
        plan = check.Plan(seed, mix["streams"], cell["check"])
        t0 = time.perf_counter()
        outputs = [plan.keep(i, *call(pool[i % len(pool)])) for i in range(args.calls)]
        served = time.perf_counter() - t0
        t0 = time.perf_counter()
        worst = check.compare(outputs, pool, seed, cfg, mix, cell["check"], params,
                              device)
        print(json.dumps({"side": "program", "seed": seed, **worst.value,
                          "at": worst.at, "frames": worst.frames, "served_s": served,
                          "check_s": time.perf_counter() - t0}), flush=True)
        del outputs
    del recon
    torch.cuda.empty_cache()
    for seed in args.control_seeds:
        pool = traffic.make_pool(seed, mix, device)
        t0 = time.perf_counter()
        worst = check.compare(None, pool, seed, cfg, mix, cell["check"], params, device,
                              rounding=fp8_rounding, calls=args.calls)
        print(json.dumps({"side": "control_fp8", "seed": seed, **worst.value,
                          "at": worst.at, "frames": worst.frames, "check_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
