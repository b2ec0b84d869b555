"""The reference's tests/test_runtime_env_pip.py on the port, case for case after
the rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the conftest
fixtures -> ray_tpu_torch.testing's). No case differs.

runtime_env pip support: per-spec cached venvs, offline wheel install.

Reference analog: python/ray/_private/runtime_env/pip.py (PipProcessor).
The test builds a local wheel and installs it with --no-index so no network
is needed."""

import os
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401

WHEEL_NAME = "rtpu_testpkg-0.1.0-py3-none-any.whl"


def _build_wheel(dirpath: str) -> str:
    """A minimal spec-compliant wheel for a one-module package."""
    path = os.path.join(dirpath, WHEEL_NAME)
    meta = (
        "Metadata-Version: 2.1\nName: rtpu-testpkg\nVersion: 0.1.0\n"
    )
    wheel = (
        "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib: true\n"
        "Tag: py3-none-any\n"
    )
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("rtpu_testpkg/__init__.py", "MAGIC = 12345\n")
        zf.writestr("rtpu_testpkg-0.1.0.dist-info/METADATA", meta)
        zf.writestr("rtpu_testpkg-0.1.0.dist-info/WHEEL", wheel)
        zf.writestr(
            "rtpu_testpkg-0.1.0.dist-info/RECORD",
            "rtpu_testpkg/__init__.py,,\n"
            "rtpu_testpkg-0.1.0.dist-info/METADATA,,\n"
            "rtpu_testpkg-0.1.0.dist-info/WHEEL,,\n"
            "rtpu_testpkg-0.1.0.dist-info/RECORD,,\n",
        )
    return path


def test_pip_env_installs_and_imports(torch_shutdown_only, tmp_path):
    _build_wheel(str(tmp_path))
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote(
        runtime_env={
            "pip": {
                "packages": ["rtpu-testpkg"],
                "pip_install_options": [
                    "--no-index", "--find-links", str(tmp_path),
                ],
            }
        }
    )
    def use_pkg():
        import rtpu_testpkg

        return rtpu_testpkg.MAGIC

    assert ray_tpu_torch.get(use_pkg.remote(), timeout=180) == 12345


def test_pip_install_failure_is_loud(torch_shutdown_only, tmp_path):
    """A missing package must FAIL the task (previously pip was silently
    ignored and the task ran without its dependencies)."""
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)

    @ray_tpu_torch.remote(
        max_retries=0,
        runtime_env={
            "pip": {
                "packages": ["definitely-not-a-real-pkg-xyz"],
                "pip_install_options": [
                    "--no-index", "--find-links", str(tmp_path),
                ],
            }
        },
    )
    def f():
        return 1

    with pytest.raises(Exception, match="pip install"):
        ray_tpu_torch.get(f.remote(), timeout=180)


def test_conda_rejected_at_submission(torch_shutdown_only):
    ray_tpu_torch.init(num_cpus=1, num_gpus=0)

    @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["x"]}})
    def f():
        return 1

    with pytest.raises(Exception, match="conda"):
        ray_tpu_torch.get(f.remote(), timeout=60)
