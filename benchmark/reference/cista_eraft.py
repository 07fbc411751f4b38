"""cista-eraft: E-RAFT's flow of each step from the previous and the
current voxel. It needs no frame, so ``flow_chunk`` steps run as one
batch."""
import torch

from . import nets
from .recurrence import Recurrence


class Streams(Recurrence):
    def flows(self, voxels):
        t_len, b = voxels.shape[:2]
        seq = torch.cat([self.prev_voxel[None], voxels])
        self.prev_voxel = voxels[-1]
        flows = []
        for i in range(0, t_len, self.flow_chunk):
            j = min(i + self.flow_chunk, t_len)
            fmaps = nets.eraft_fnet(self.ops, seq[i:j + 1].reshape(-1, *seq.shape[2:]))
            fmaps = fmaps.reshape(j - i + 1, b, *fmaps.shape[1:])
            cnet = nets.eraft_cnet(self.ops, seq[i + 1:j + 1].reshape(-1, *seq.shape[2:]))
            f = nets.eraft_flow(self.ops, fmaps[:-1].flatten(0, 1), fmaps[1:].flatten(0, 1),
                                cnet, self.iters, self.hw)
            flows.append(f.reshape(j - i, b, *f.shape[1:]))
        return torch.cat(flows)
