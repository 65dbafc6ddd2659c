"""The port's counterpart of ``ray_tpu/job_submission/``: driver scripts run
as supervised subprocesses, each the leader of its own process group."""

from ray_tpu_torch.job_submission.job_manager import (
    JobInfo,
    JobManager,
    JobStatus,
    JobSubmissionClient,
)

__all__ = ["JobInfo", "JobManager", "JobStatus", "JobSubmissionClient"]
