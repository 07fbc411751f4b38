"""Device time per step of the flow net (CUDA events around the outermost
call of its modules): DCEIFlow, or E-RAFT with, in the time-parallel
window, its encoders called on their own."""

KIND = "per_layer"
UNIT = "ms"
STAGES = {"flownet": ["event_flownet", "event_flownet.fnet", "event_flownet.cnet"]}


def read(run):
    tr = run.trace
    ms = tr.stage_ms.get("flownet") if tr else None
    return ms / run.traced_steps if ms else None
