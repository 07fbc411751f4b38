"""``Reconstructor.step``: one step of every stream a call, its frames and
flows returned to the host."""


def make(recon, streams: int):
    def call(voxels):
        frames, flows = recon.step(voxels)
        if streams == 1:
            frames, flows = frames[None], flows[None]
        return frames[None], flows[None]
    return call
