"""The port's operators: the hand-written kernels' wrappers (one module
each) and the transforms that JAX's ``ops`` exports, under the same names
(``events_to_voxel_grid_host``, which dispatches to JAX's native C++
helper, has no counterpart)."""
from .voxel import (
    events_to_voxel_grid, events_to_voxel_grid_np, events_to_voxel_grid_scatter,
    events_to_voxel_grid_matmul, events_to_voxel_grid_pallas,
    events_to_voxel_grid_sortseg, normalize_voxel_grid, normalize_voxel_grid_np,
)
from .depth import (
    depth_to_log, depth_to_log_np, log_to_depth, log_to_depth_np, rgb_to_gray_np,
)
from .gradient import spatial_gradient, avg_pool, sobel_magnitude

__all__ = [
    "events_to_voxel_grid", "events_to_voxel_grid_np", "events_to_voxel_grid_scatter",
    "events_to_voxel_grid_matmul", "events_to_voxel_grid_pallas",
    "events_to_voxel_grid_sortseg",
    "normalize_voxel_grid", "normalize_voxel_grid_np",
    "depth_to_log", "depth_to_log_np", "log_to_depth", "log_to_depth_np",
    "rgb_to_gray_np", "spatial_gradient", "avg_pool", "sobel_magnitude",
]
