"""The port's counterpart of ``ray_tpu/experimental/``: the shared-memory
channels of compiled DAGs and the internal KV store."""

from ray_tpu_torch.experimental import internal_kv

__all__ = ["internal_kv"]
