"""Int8 post-training quantization of the port (``quant/ptq.py``,
``quant/gptq.py``), the counterpart of ``refinedet_tpu/quant``."""

from refinedet_tpu_torch.quant.gptq import (accumulate_hessians, conv_geometry,
                                            gptq_round)
from refinedet_tpu_torch.quant.ptq import (ACT_STATS, CALIB_PERCENTILES,
                                           DEFAULT_QUANT_SKIP,
                                           bias_correction_delta,
                                           calib_batches_from_dataset,
                                           calibrate_amax, quantize_model,
                                           quantize_variables)

__all__ = ["ACT_STATS", "CALIB_PERCENTILES", "DEFAULT_QUANT_SKIP",
           "bias_correction_delta", "calib_batches_from_dataset",
           "calibrate_amax", "quantize_model", "quantize_variables",
           "accumulate_hessians", "conv_geometry", "gptq_round"]
