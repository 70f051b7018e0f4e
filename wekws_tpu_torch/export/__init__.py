"""Graph-artifact export, int8 quantization and artifact runtimes: the
port of wekws_tpu/export (A.12).  ``GraphRuntime`` is the numpy
interpreter (the C++ runtime's executable specification),
``TorchGraphRuntime`` the batched device runtime that serves an
artifact."""

from wekws_tpu_torch.export.graph import export_model, load_artifact
from wekws_tpu_torch.export.np_runtime import GraphRuntime
from wekws_tpu_torch.export.quantize import quantize_artifact
from wekws_tpu_torch.export.torch_runtime import TorchGraphRuntime

__all__ = ["export_model", "load_artifact", "GraphRuntime",
           "TorchGraphRuntime", "quantize_artifact"]
