from refinedet_tpu_torch.eval.coco_eval import COCOeval, Params, box_iou_xywh
from refinedet_tpu_torch.eval.evaluator import Evaluator
from refinedet_tpu_torch.eval.voc_eval import (evaluate_voc, voc_ap,
                                               voc_eval_class,
                                               write_voc_results_files)

__all__ = ["COCOeval", "Params", "box_iou_xywh", "Evaluator",
           "evaluate_voc", "voc_ap", "voc_eval_class",
           "write_voc_results_files"]
