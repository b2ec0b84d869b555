"""ray_tpu_torch.job: job submission (reference: dashboard/modules/job).

A submitted job = a detached JobSupervisor actor that runs the entrypoint as
a subprocess, streams its output into the GCS KV, and records JobInfo status
transitions (PENDING -> RUNNING -> SUCCEEDED/FAILED/STOPPED), mirroring
dashboard/modules/job/job_manager.py:56 + job_supervisor.py:49.
"""

from ray_tpu_torch.job.job_manager import (
    JobInfo,
    JobStatus,
    JobSubmissionClient,
)

__all__ = ["JobInfo", "JobStatus", "JobSubmissionClient"]
