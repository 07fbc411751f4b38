"""Host-side event voxelization (numpy)."""
from .voxel import event_preprocess, events_to_voxel_grid

__all__ = ["event_preprocess", "events_to_voxel_grid"]
