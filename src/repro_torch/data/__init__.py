from repro_torch.data.datasets import Dataset, get_dataset, register_dataset
from repro_torch.data.groundtruth import exact_knn

__all__ = ["Dataset", "get_dataset", "register_dataset", "exact_knn"]
