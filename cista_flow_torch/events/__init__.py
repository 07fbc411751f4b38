"""Host-side event voxelization: the host event library, numpy beside it."""
from .voxel import (add_noise_to_voxel, event_preprocess, event_preprocess_numpy,
                    events_to_voxel_grid, events_to_voxel_grid_numpy, events_to_voxel_grid_pol)

__all__ = ["add_noise_to_voxel", "event_preprocess", "event_preprocess_numpy",
           "events_to_voxel_grid", "events_to_voxel_grid_numpy", "events_to_voxel_grid_pol"]
