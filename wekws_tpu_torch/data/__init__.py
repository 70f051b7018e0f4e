"""Data package: the host pipeline (list -> batches) and the device
feature pipeline.

Imports are lazy so loader worker processes (spawn context) unpickle
Dataset objects without importing torch: a worker never touches CUDA.
DeviceFeaturePipeline pulls torch only when asked for.
"""


def __getattr__(name):
    if name in ("Dataset", "init_dataset"):
        from wekws_tpu_torch.data import dataset as _d

        return getattr(_d, name)
    if name == "DataLoader":
        from wekws_tpu_torch.data.loader import DataLoader

        return DataLoader
    if name == "DeviceFeaturePipeline":
        from wekws_tpu_torch.data.device_pipeline import DeviceFeaturePipeline

        return DeviceFeaturePipeline
    raise AttributeError(name)


__all__ = ["DataLoader", "Dataset", "DeviceFeaturePipeline", "init_dataset"]
