from refinedet_tpu_torch.data.augmentations import (BaseTransform,
                                                    SSDAugmentation)
from refinedet_tpu_torch.data.coco_io import COCO
from refinedet_tpu_torch.data.collate import (Batch, detection_collate,
                                              pad_batch, pad_targets)
from refinedet_tpu_torch.data.loader import (DataLoader, DeviceStager,
                                             StagedBatch)
from refinedet_tpu_torch.data.sarship import COCODetection
from refinedet_tpu_torch.data.voc import (VOC_CLASSES,
                                          VOCAnnotationTransform,
                                          VOCDetection)

__all__ = ["BaseTransform", "SSDAugmentation", "Batch", "COCO",
           "COCODetection", "DataLoader", "DeviceStager", "StagedBatch",
           "VOC_CLASSES", "VOCAnnotationTransform", "VOCDetection",
           "detection_collate", "pad_batch", "pad_targets"]
