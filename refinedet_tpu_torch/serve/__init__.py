from refinedet_tpu_torch.serve.export import (FusedNms, ServingModel,
                                              export_inference,
                                              fused_postprocess, load_serving,
                                              make_serving_fn, save_serving)
from refinedet_tpu_torch.serve.server import (BatchingEngine,
                                              EngineOverloadedError, Server,
                                              client_detect)

__all__ = ["BatchingEngine", "EngineOverloadedError", "FusedNms", "Server",
           "ServingModel", "client_detect", "export_inference",
           "fused_postprocess", "load_serving", "make_serving_fn",
           "save_serving"]
