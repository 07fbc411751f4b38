"""One run of one cell: set-up, the measured window, the check, the result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``workloads/<cell>.json``) names its configuration
(``configs/<name>.json``), its traffic mix (``mixes/<name>.json``), the
program's entry that its calls drive (``entries/<name>.py``), the
end-to-end metrics it reports, its traced slice and its check. Metrics
are the files of ``metrics/``, kernel work counters those of
``kernels/`` and the reference of each model mode ``reference/<mode>.py``,
all found by name; a later cell, mix, configuration, entry, metric,
counter or model mode is a new file.

The window is a closed loop: each stream is one continuous sequence, and
the next call goes in when the previous one has returned its frames and
flows to the host. With ``--trace 0`` the last line of standard output
holds the cell's end-to-end metrics; with ``--trace 1`` the per-layer
metrics of a traced slice of the window, its busy and window seconds and
its breakdown. Both compare the window's frames and flows with the plain
reference afterwards (``check.py``).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROGRAM = "cista_flow_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cista_flow_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """(cell, configuration, traffic mix) of a cell, by name."""
    cell = read_json(BENCH / "workloads" / f"{name}.json")
    return (cell, read_json(BENCH / "configs" / f"{cell['config']}.json"),
            read_json(BENCH / "mixes" / f"{cell['traffic']}.json"))


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def set_cache_dirs() -> None:
    """Fixed cache directories inside the checkout (``build/`` is not
    committed), so that only a checkout's first run compiles. The
    program's nvcc libraries go to ``build/kernels`` by its own rule."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def flops_per_frame(params: dict, cfg: dict, mix: dict) -> float:
    """``reference.flops_per_frame``, counted on a checkout's first run of
    the cell and read from ``build/bench_cache/flops`` afterwards (keyed by
    the configuration, the mix and the reference's sources)."""
    import hashlib

    import reference
    h = hashlib.sha1(json.dumps([cfg, mix], sort_keys=True).encode())
    for path in sorted((BENCH / "reference").glob("*.py")):
        h.update(path.read_bytes())
    path = ROOT / "build" / "bench_cache" / "flops" / f"{h.hexdigest()[:16]}.json"
    if path.exists():
        return read_json(path)["flops_per_frame"]
    flops = reference.flops_per_frame(params, cfg, mix)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps({"flops_per_frame": flops}))
    os.replace(tmp, path)
    return flops


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class Run:
    """What the metric readers read."""

    def __init__(self):
        self.calls = self.frames = 0
        self.latencies = []
        self.window_s = self.setup_s = 0.0
        self.flops_per_frame = 0.0
        self.trace = None
        self.traced_steps = self.traced_frames = 0


def port_call(recon, entry: str, streams: int):
    """The program's serving entry that a call of the cell drives, from
    ``entries/<entry>.py``: host voxels in, host (frames (T, B, H, W),
    flows (T, B, 2, H, W)) out."""
    from tracing import load_files
    return load_files(BENCH / "entries")[entry].make(recon, streams)


def build_program(cfg: dict, mix: dict, device):
    from cista_flow_torch.config import Config
    from cista_flow_torch.runner import Reconstructor
    config = Config(image_dim=(mix["height"], mix["width"]), model_mode=cfg["model_mode"],
                    num_bins=cfg["num_bins"], depth=cfg["depth"],
                    base_channels=cfg["base_channels"], flow_iters=cfg["flow_iters"],
                    dtype=cfg["dtype"], path_to_test_model=str(ROOT / cfg["weights"]))
    return Reconstructor(config, device=device, batch=mix["streams"])


def measure(name: str, seed: int, seconds: float, trace: bool, device="cuda",
            cell=None, program=None) -> tuple:
    """One run; returns (result dict, check lines, ``Run``, ``check.Worst``). ``cell`` (cell,
    configuration, mix) replaces the files of ``name``; ``program`` wraps
    the program's call (tests plant faults through it)."""
    import torch

    import check
    import reference
    import traffic
    from tracing import Tracer, load_files

    cell, cfg, mix = cell or load_cell(name)
    metrics = load_files(BENCH / "metrics")
    on_card = torch.device(device).type == "cuda"
    run = Run()
    marks = [("start", process_age_s())]
    pool = traffic.make_pool(seed, mix, device)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = reference.load_params(str(ROOT / cfg["weights"]), "cpu")
    marks.append(("traffic", process_age_s()))
    run.flops_per_frame = flops_per_frame(params, cfg, mix)
    marks.append(("weights and operation count", process_age_s()))

    recon = build_program(cfg, mix, device)
    call = port_call(recon, cell["entry"], mix["streams"])
    if program is not None:
        call = program(call, recon)
    marks.append(("program", process_age_s()))
    call(pool[0])                      # warm-up at the cell's shapes: builds and loads
    recon.reset()
    marks.append(("warm-up", process_age_s()))
    tracer = None
    if trace:
        tracer = Tracer(recon.model, load_files(BENCH / "kernels"), metrics,
                        cell["trace"]["calls"])
    plan = check.Plan(seed, mix["streams"], cell["check"])
    gc.collect()
    gc.freeze()
    outputs, failed = [], 0
    run.setup_s = process_age_s()
    t_start = t_end = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        i = len(outputs)
        if tracer is not None and i == tracer.start_call:
            tracer.begin()
        t0 = time.perf_counter()
        try:
            out = call(pool[i % len(pool)])
        except Exception as exc:  # a failed call ends the window; the run reports it
            print(f"call {i} failed: {exc!r}", file=sys.stderr)
            failed += 1
            break
        t_end = time.perf_counter()
        run.latencies.append(t_end - t0)
        outputs.append(plan.keep(i, *out))
        del out
        if tracer is not None and len(outputs) == tracer.stop_call:
            tracer.end(tracer.stop_call - tracer.start_call)
    gc.unfreeze()
    run.calls = len(outputs)
    run.frames = run.calls * mix["streams"] * mix["steps_per_call"]
    run.window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    if tracer is not None:
        if tracer.prof is not None and tracer.calls == 0:     # the window ended inside the slice
            tracer.end(len(outputs) - tracer.start_call)
        if tracer.calls > 0:
            run.trace = tracer.read()
            run.traced_steps = tracer.calls * mix["steps_per_call"]
            run.traced_frames = run.traced_steps * mix["streams"]

    del recon, call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    limits = {k: v for k, v in cell["check"]["limits"].items() if v is not None}
    worst = check.compare(outputs, pool, seed, cfg, mix, cell["check"],
                          {k: v.to(device) for k, v in params.items()}, device)
    correct = failed == 0 and run.calls > 0 and bool(limits) and all(
        worst.value[k] <= limit for k, limit in limits.items())
    checks = {k: {"value": worst.value[k], "limit": limit} for k, limit in limits.items()}
    lines = ["set-up s: " + ", ".join(f"{k} {b - a:.2f}" for (_, a), (k, b)
                                      in zip(marks, marks[1:]))
             + f" (imports and card before: {marks[0][1]:.2f})"]
    lines += [f"reading {k} {worst.value[k]!r} (not compared) at (call, step, stream) "
              f"{worst.at[k]}" for k in check.READINGS if k not in limits]
    lines += [f"check {k} {worst.value[k]!r} limit {limit!r} at (call, step, stream) "
              f"{worst.at[k]} over {worst.frames} frames" for k, limit in limits.items()]

    kind = "per_layer" if trace else "end_to_end"
    wanted = [k for k, m in metrics.items() if m.KIND == kind
              and (trace or k in cell["end_to_end"])]
    values = {}
    for k in wanted:
        v = metrics[k].read(run)
        if v is not None:
            values[k] = {"value": float(v), "unit": metrics[k].UNIT}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run.calls + failed, "failed": failed,
              "metrics": values, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result, lines, run, worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    if not (ROOT / PROGRAM / "__init__.py").exists():
        print(f"the program ({PROGRAM}) is not in {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    cell = load_cell(args.workload)
    import torch
    torch.set_num_threads(1)           # one thread: the host's other tenants share its cores
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell[0]["chips"]:
        print(f"{args.workload} needs {cell[0]['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines, _, _ = measure(args.workload, args.seed, args.seconds, bool(args.trace),
                            cell=cell)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
