"""Job manager: supervisor actor + submission client.

Analog of dashboard/modules/job/job_manager.py (JobManager:56) and
job_supervisor.py (JobSupervisor:49): the supervisor is a detached actor so
the job outlives the submitting client, and it ends itself once the job has
ended; logs and JobInfo live in the GCS KV.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

JOB_INFO_NS = "job_info"
JOB_LOGS_NS = "job_logs"
MAX_LOG_BYTES = 4 * 1024 * 1024


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    runtime_env: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_json(cls, blob: bytes) -> "JobInfo":
        return cls(**json.loads(blob))


class JobSupervisor:
    """Detached actor running one job's entrypoint as a subprocess."""

    def __init__(self, submission_id: str, entrypoint: str, info_json: bytes):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.info = JobInfo.from_json(info_json)
        self.proc = None
        self._stopped = False

    async def _kv_put(self, ns: str, key: str, value: bytes) -> None:
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod._core()
        await core.gcs.kv_put(key, value, ns=ns)

    async def _set_status(self, status: str, message: str = "") -> None:
        self.info.status = status
        self.info.message = message
        if status in JobStatus.TERMINAL:
            self.info.end_time = time.time()
        await self._kv_put(JOB_INFO_NS, self.submission_id, self.info.to_json())

    async def run(self) -> str:
        """Run the entrypoint to completion; returns final status."""
        import asyncio

        from ray_tpu_torch._private import rpc
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod._core()
        env = dict(os.environ)
        # The job's own driver connects to this same cluster: init(address=
        # "auto") reads the port's variable, never ray_tpu's.
        gcs_host, gcs_port = core.gcs.conn.peername
        env["RAY_TPU_TORCH_ADDRESS"] = f"{gcs_host}:{gcs_port}"
        env.update(self.info.runtime_env.get("env_vars") or {})
        cwd = self.info.runtime_env.get("working_dir") or None

        await self._set_status(JobStatus.RUNNING)
        log_buf = bytearray()
        last_flush = 0.0
        try:
            self.proc = await asyncio.create_subprocess_shell(
                self.entrypoint,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.STDOUT,
                env=env,
                cwd=cwd,
            )
            assert self.proc.stdout is not None
            while True:
                line = await self.proc.stdout.readline()
                if not line:
                    break
                log_buf.extend(line)
                if len(log_buf) > MAX_LOG_BYTES:
                    del log_buf[: len(log_buf) - MAX_LOG_BYTES]
                # Throttled flush: pushing the whole buffer per line would be
                # O(lines x buffer) KV traffic for chatty jobs.
                now = time.monotonic()
                if now - last_flush >= 1.0:
                    last_flush = now
                    await self._kv_put(
                        JOB_LOGS_NS, self.submission_id, bytes(log_buf)
                    )
            code = await self.proc.wait()
            if self._stopped:
                await self._set_status(JobStatus.STOPPED, "stopped by user")
            elif code == 0:
                await self._set_status(JobStatus.SUCCEEDED)
            else:
                await self._set_status(JobStatus.FAILED, f"exit code {code}")
        except Exception as e:  # noqa: BLE001
            await self._set_status(JobStatus.FAILED, f"{type(e).__name__}: {e}")
        finally:
            await self._kv_put(JOB_LOGS_NS, self.submission_id, bytes(log_buf))
            # The job is over and its record is in the KV: the supervisor ends
            # itself, so its node no longer counts as busy.
            rpc.spawn(core.kill_actor(core.current_actor_id))
        return self.info.status

    async def stop(self) -> bool:
        self._stopped = True
        if self.proc is not None and self.proc.returncode is None:
            try:
                self.proc.terminate()
            except ProcessLookupError:
                pass
        return True

    async def ping(self) -> str:
        return "pong"


class JobSubmissionClient:
    """Analog of the reference SDK (dashboard/modules/job/sdk.py), talking
    directly to the cluster instead of through the dashboard REST layer."""

    def __init__(self, address: Optional[str] = None):
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address) if address else ray_tpu_torch.init()
        self._ray = ray_tpu_torch

    def _kv_get(self, ns: str, key: str) -> Optional[bytes]:
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod._core()
        return worker_mod.global_worker.run_async(core.gcs.kv_get(key, ns=ns))

    def _kv_keys(self, ns: str) -> List[str]:
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod._core()
        return worker_mod.global_worker.run_async(core.gcs.kv_keys("", ns=ns))

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[Dict[str, Any]] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        submission_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        info = JobInfo(
            submission_id=submission_id,
            entrypoint=entrypoint,
            runtime_env=runtime_env or {},
            metadata=metadata or {},
        )
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod._core()
        worker_mod.global_worker.run_async(
            core.gcs.kv_put(submission_id, info.to_json(), ns=JOB_INFO_NS)
        )
        supervisor = (
            self._ray.remote(JobSupervisor)
            .options(
                name=f"_job_supervisor:{submission_id}",
                namespace="_job",
                lifetime="detached",
                max_concurrency=4,
                num_cpus=0.1,
            )
            .remote(submission_id, entrypoint, info.to_json())
        )
        # Fire-and-forget; the returned ref resolves when the job finishes.
        supervisor.run.remote()
        return submission_id

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id).status

    def get_job_info(self, submission_id: str) -> JobInfo:
        blob = self._kv_get(JOB_INFO_NS, submission_id)
        if blob is None:
            raise ValueError(f"no job {submission_id!r}")
        return JobInfo.from_json(blob)

    def get_job_logs(self, submission_id: str) -> str:
        blob = self._kv_get(JOB_LOGS_NS, submission_id)
        return (blob or b"").decode(errors="replace")

    def list_jobs(self) -> List[JobInfo]:
        out = []
        for key in self._kv_keys(JOB_INFO_NS):
            blob = self._kv_get(JOB_INFO_NS, key)
            if blob:
                out.append(JobInfo.from_json(blob))
        out.sort(key=lambda j: j.start_time)
        return out

    def stop_job(self, submission_id: str) -> bool:
        """False for an unknown job and for one that has ended (its
        supervisor is gone with it)."""
        blob = self._kv_get(JOB_INFO_NS, submission_id)
        if blob is None or JobInfo.from_json(blob).status in JobStatus.TERMINAL:
            return False
        try:
            sup = self._ray.get_actor(
                f"_job_supervisor:{submission_id}", namespace="_job"
            )
        except ValueError:
            return False
        return self._ray.get(sup.stop.remote())

    def wait_until_finish(
        self, submission_id: str, timeout_s: float = 300.0, poll_s: float = 0.5
    ) -> str:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(poll_s)
        raise TimeoutError(f"job {submission_id} still {status} after {timeout_s}s")
