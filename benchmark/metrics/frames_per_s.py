"""Frames returned to the host (streams x steps of every completed call)
over all the time from the window's start to the end of its last call."""

KIND = "end_to_end"
UNIT = "frames/s"


def read(run):
    return run.frames / run.window_s if run.calls else None
