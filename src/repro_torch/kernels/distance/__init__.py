from repro_torch.kernels.distance.distance import distance_epilogue
from repro_torch.kernels.distance.ref import distance_matrix_ref

__all__ = ["distance_epilogue", "distance_matrix_ref"]
