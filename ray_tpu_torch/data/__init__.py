"""ray_tpu_torch.data — device-resident batches for the training ranks."""

from ray_tpu_torch.data.iterator import iter_device_batches

__all__ = ["iter_device_batches"]
