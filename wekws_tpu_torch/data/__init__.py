"""Device feature pipeline (the host data pipeline is not ported yet)."""

from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline

__all__ = ["DeviceFeaturePipeline"]
