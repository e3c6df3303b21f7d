from repro_torch.kernels.distance.distance import (distance_epilogue,
                                                   distance_matrix_kernel,
                                                   distance_matrix_plain)
from repro_torch.kernels.distance.ops import distance_matrix, pick_tiles
from repro_torch.kernels.distance.ref import distance_matrix_ref

__all__ = ["distance_epilogue", "distance_matrix", "distance_matrix_kernel",
           "distance_matrix_plain", "distance_matrix_ref", "pick_tiles"]
