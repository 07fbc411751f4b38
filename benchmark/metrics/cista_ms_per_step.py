"""Device time per step of CISTA-LSTC (CUDA events around ``cista_net``)."""

KIND = "per_layer"
UNIT = "ms"
STAGES = {"cista": ["cista_net"]}


def read(run):
    tr = run.trace
    ms = tr.stage_ms.get("cista") if tr else None
    return ms / run.traced_steps if ms else None
