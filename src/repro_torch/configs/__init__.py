from repro_torch.configs.registry import all_archs, all_cells, get_arch

__all__ = ["all_archs", "all_cells", "get_arch"]
