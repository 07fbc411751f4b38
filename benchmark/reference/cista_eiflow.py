"""cista-eiflow: DCEIFlow's flow of each step from its voxel and the
previous frame, so the steps run one after another."""
from . import nets
from .recurrence import Recurrence


class Streams(Recurrence):
    def flows(self, voxels):
        for ev in voxels:
            yield nets.dceiflow(self.ops, ev, self.prev_frame, self.iters)
