"""The port's counterpart of ``ray_tpu/dashboard/``: the state API over
HTTP, on driver threads."""

from ray_tpu_torch.dashboard.app import start_dashboard, stop_dashboard

__all__ = ["start_dashboard", "stop_dashboard"]
