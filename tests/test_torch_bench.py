"""ray_tpu_torch.bench on the CPU: without a card it raises; the step
phase's probe counts the flops the analytic count gives; importing the
module imports no torch, since the e2e phase's data tasks import it to run
`synth_block`."""

import math
import os
import subprocess
import sys

import pytest
import torch

from ray_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
    for phase in (bench.phase_step, bench.phase_transformer, bench.phase_e2e):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            phase("cuda")


def test_step_phase_probe_on_cpu():
    out = bench.phase_step("cpu")
    assert out["device_kind"] == "cpu" and out["mfu"] is None and out["peak_flops"] is None
    assert out["flops_per_image"] == out["analytic_flops_per_image"]
    assert out["step_images_per_sec"] > 0
    assert math.isfinite(out["step_loss_first"]) and math.isfinite(out["step_loss_last"])


def test_importing_the_bench_imports_no_torch():
    code = "import sys, ray_tpu_torch.bench; print('torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
