from repro_torch.kernels.adc_scan.adc_scan import (MAX_C, adc_scan_kernel,
                                                   adc_scan_plain,
                                                   adc_sums_kernel,
                                                   adc_sums_plain)
from repro_torch.kernels.adc_scan.ops import (adc_scan, adc_window_topk,
                                              pick_adc_block)
from repro_torch.kernels.adc_scan.ref import adc_scan_ref

__all__ = ["MAX_C", "adc_scan", "adc_scan_kernel", "adc_scan_plain",
           "adc_scan_ref", "adc_sums_kernel", "adc_sums_plain",
           "adc_window_topk", "pick_adc_block"]
