"""GPU accelerator manager: detection and per-process card visibility.

The GPU counterpart of ``ray_tpu/tpu/accelerator.py:TPUAcceleratorManager``
(reference: ``python/ray/_private/accelerators/nvidia_gpu.py``). Plain
static methods: the train worker group uses them to give each rank its
card, and a user may register them with ray_tpu's runtime; the port never
imports that runtime to do so.

Nothing here creates a CUDA context: the count comes from
``CUDA_VISIBLE_DEVICES`` or from ``torch.cuda.device_count()``, which asks
NVML where it can, and the card's name from ``nvidia-smi``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"


class GPUAcceleratorManager:
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[list[str]]:
        """The ids in ``CUDA_VISIBLE_DEVICES`` (``[]`` when it is set empty
        or to NoDevFiles), or None when it is unset."""
        v = os.environ.get(CUDA_VISIBLE_DEVICES)
        if v is None:
            return None
        if v.strip() in ("", "NoDevFiles"):
            return []
        return [s.strip() for s in v.split(",") if s.strip()]

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        ids = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        if ids is not None:
            return len(ids)
        import torch

        return torch.cuda.device_count()

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """The first visible card's name as nvidia-smi gives it, or None."""
        if GPUAcceleratorManager.get_current_node_num_accelerators() == 0:
            return None
        smi = shutil.which("nvidia-smi")
        if smi is None:
            return None
        ids = GPUAcceleratorManager.get_current_process_visible_accelerator_ids()
        cmd = [smi, "--query-gpu=name", "--format=csv,noheader"]
        if ids:
            cmd.append(f"--id={ids[0]}")
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
        names = out.stdout.strip().splitlines() if out.returncode == 0 else []
        return names[0].strip() if names else None

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> tuple[bool, Optional[str]]:
        """Whole cards only, as the TPU manager takes whole chips."""
        if quantity < 0 or quantity != int(quantity):
            return False, f"GPU resource quantities must be whole cards, got {quantity}"
        return True, None

    @staticmethod
    def get_visibility_env(gpu_ids: list) -> dict[str, str]:
        """Env for a process restricted to ``gpu_ids`` (physical ids, or the
        entries of this process's own ``CUDA_VISIBLE_DEVICES``)."""
        return {CUDA_VISIBLE_DEVICES: ",".join(str(i) for i in gpu_ids)}
