# The modules register the ops refinedet_tpu_torch::int8_conv,
# refinedet_tpu_torch::int8_quantize and refinedet_tpu_torch::conv_bias_relu.
from refinedet_tpu_torch.ops import conv_epilogue, int8_conv  # noqa: F401
from refinedet_tpu_torch.ops.dispatch import (batched_nms_auto,
                                              class_parallel_nms)
from refinedet_tpu_torch.ops.nms import (NmsResult, nms, nms_sweep_reference,
                                         select_candidates, soft_nms)
from refinedet_tpu_torch.ops.nms_cuda import nms_sweep

__all__ = ["NmsResult", "batched_nms_auto", "class_parallel_nms", "nms",
           "nms_sweep", "nms_sweep_reference", "select_candidates",
           "soft_nms"]
