"""``Reconstructor.step_window(..., return_all=True)``: the time-parallel
window, every step's frames and flows returned to the host."""


def make(recon, streams: int):
    def call(voxels):
        frames, flows = recon.step_window(voxels, return_all=True)
        if streams == 1:
            frames, flows = frames[:, None], flows[:, None]
        return frames, flows
    return call
