"""Device time per step of the traced slice's copies: voxels up, frames
and flows down."""

KIND = "per_layer"
UNIT = "ms"


def read(run):
    tr = run.trace
    if not tr or not run.traced_steps:
        return None
    s = tr.device_seconds("gpu_memcpy")
    return s * 1e3 / run.traced_steps if s > 0 else None
