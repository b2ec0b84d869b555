"""The reference's tests/test_runtime_env_conda_container.py on the port, case
for case after the rename (ray_tpu -> ray_tpu_torch, num_tpus -> num_gpus, the
conftest fixtures -> ray_tpu_torch.testing's). No case differs.

conda + container runtime envs (reference:
python/ray/_private/runtime_env/conda.py + container.py). Both runtimes are
exercised through fake executables on PATH — the same injectable-runner
pattern the GCE provider tests use — so the full worker path runs without
conda/podman installed."""

import os
import stat
import sys
import textwrap

import pytest

import ray_tpu_torch
from ray_tpu_torch.testing import torch_shutdown_only  # noqa: F401
from ray_tpu_torch.runtime_env.container import build_container_argv


# -- container argv construction (unit) --------------------------------------


def test_container_argv_shape(tmp_path):
    argv = build_container_argv(
        {"image": "rayproject/ray:latest", "run_options": ["--cpus=2"]},
        [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
        {"RAY_TPU_NODE_ID": "abc", "RAY_TPU_WORKER_ID": "w1"},
        runtime="/usr/bin/podman",
    )
    assert argv[0] == "/usr/bin/podman"
    assert argv[1] == "run"
    assert "--network=host" in argv
    assert "--env" in argv and "RAY_TPU_NODE_ID=abc" in argv
    assert "--cpus=2" in argv
    img = argv.index("rayproject/ray:latest")
    # Inside the image: the image's python, then the worker module.
    assert argv[img + 1 :] == ["python3", "-m", "ray_tpu_torch._private.worker_main"]
    with pytest.raises(ValueError):
        build_container_argv({}, [sys.executable], {}, runtime="podman")


def _write_exe(path, body: str) -> str:
    path.write_text(body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


# -- conda env provisioning through a fake conda binary ----------------------


@pytest.fixture
def fake_conda_path(tmp_path):
    """A `conda` shim implementing `conda env create -p <prefix> -f <yaml>`:
    creates the prefix with a site-packages containing a marker module whose
    content records the env name from the yaml."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    _write_exe(
        bindir / "conda",
        textwrap.dedent(
            f"""\
            #!{sys.executable}
            import os, sys
            args = sys.argv[1:]
            assert args[0:2] == ["env", "create"], args
            prefix = args[args.index("-p") + 1]
            site = os.path.join(
                prefix, "lib",
                f"python{{sys.version_info.major}}.{{sys.version_info.minor}}",
                "site-packages",
            )
            os.makedirs(site, exist_ok=True)
            with open(os.path.join(site, "conda_marker.py"), "w") as f:
                f.write("PROVISIONED_BY = 'fake-conda'\\n")
            with open(os.path.join(prefix, ".provisioned"), "w") as f:
                f.write("ok")
            """
        ),
    )
    return str(bindir)


def test_conda_env_provisioned_and_activated(tmp_path, fake_conda_path, monkeypatch):
    """ensure_conda_env drives the conda binary once (cached after), and
    activation puts the env's site-packages on sys.path."""
    import asyncio

    monkeypatch.setenv("PATH", fake_conda_path + os.pathsep + os.environ["PATH"])
    from ray_tpu_torch.runtime_env import context as ctx

    monkeypatch.setattr(ctx, "EXTRACT_ROOT", str(tmp_path / "envs"))
    spec = {"dependencies": ["python=3.12", "numpy"]}
    prefix = asyncio.run(ctx.ensure_conda_env(spec))
    assert os.path.exists(os.path.join(prefix, ".provisioned"))
    # Cached: a second call returns without re-invoking conda.
    assert asyncio.run(ctx.ensure_conda_env(spec)) == prefix
    site = ctx._conda_site_packages(prefix)
    assert os.path.exists(os.path.join(site, "conda_marker.py"))


def test_worker_boots_in_conda_env(torch_shutdown_only, tmp_path, fake_conda_path):
    """E2E: an actor with runtime_env={'conda': ...} runs in a worker whose
    sys.path contains the provisioned env — the marker module imports."""
    ray_tpu_torch.init(
        num_cpus=2,
        num_gpus=0,
        worker_env={
            "PATH": fake_conda_path + os.pathsep + os.environ["PATH"],
        },
    )

    @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["numpy"]}})
    class CondaActor:
        def probe(self):
            import conda_marker

            return conda_marker.PROVISIONED_BY

    a = CondaActor.remote()
    assert ray_tpu_torch.get(a.probe.remote()) == "fake-conda"
    ray_tpu_torch.kill(a)

    # Tasks apply conda the same way.
    @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["numpy"]}})
    def probe_task():
        import conda_marker

        return conda_marker.PROVISIONED_BY

    assert ray_tpu_torch.get(probe_task.remote()) == "fake-conda"


# -- containerized worker through a fake podman binary -----------------------


@pytest.fixture
def fake_podman_path(tmp_path):
    """A `podman` shim that strips the container argv and execs the inner
    worker command with the host python — proving the raylet built a
    correct `podman run` line and that a worker booted through it."""
    bindir = tmp_path / "cbin"
    bindir.mkdir()
    _write_exe(
        bindir / "podman",
        textwrap.dedent(
            f"""\
            #!{sys.executable}
            import os, sys
            args = sys.argv[1:]
            assert args[0] == "run", args
            env = dict(os.environ)
            i = 1
            image = None
            while i < len(args):
                a = args[i]
                if a == "--env":
                    k, _, v = args[i + 1].partition("=")
                    env[k] = v
                    i += 2
                elif a == "-v":
                    i += 2
                elif a.startswith("-"):
                    i += 1
                else:
                    image = a
                    break
            assert image == "fake/image:1", image
            env["RAY_TPU_CONTAINERIZED"] = "1"
            inner = args[i + 1 :]
            # image python3 -> host python (the shim IS the container).
            inner[0] = sys.executable
            os.execve(inner[0], inner, env)
            """
        ),
    )
    return str(bindir)


def test_actor_worker_boots_in_container(torch_shutdown_only, tmp_path, fake_podman_path):
    ray_tpu_torch.init(
        num_cpus=2,
        num_gpus=0,
        worker_env={"PATH": fake_podman_path + os.pathsep + os.environ["PATH"]},
    )
    # The raylet discovers the container runtime on ITS PATH.
    os.environ["PATH"] = fake_podman_path + os.pathsep + os.environ["PATH"]

    @ray_tpu_torch.remote(runtime_env={"container": {"image": "fake/image:1"}})
    class Boxed:
        def probe(self):
            return os.environ.get("RAY_TPU_CONTAINERIZED")

    a = Boxed.remote()
    assert ray_tpu_torch.get(a.probe.remote()) == "1"
    ray_tpu_torch.kill(a)
