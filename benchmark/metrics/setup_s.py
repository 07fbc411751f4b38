"""From the process's start to the first timed call: imports, the kernel
libraries, the weights, the voxel pool, the count of model operations and
the warm-up at the cell's shapes."""

KIND = "end_to_end"
UNIT = "s"


def read(run):
    return run.setup_s
