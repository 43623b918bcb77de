"""The port's train CLI on the CPU: `python -m repro_torch.launch.train
--smoke --device cpu` trains, checkpoints (the last step blocking, one
step async on the way), and a second call auto-resumes from the last
committed step and trains on to its own step count; without a card
and without `--device cpu` it refuses rather than dropping to the
CPU."""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def train(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--seq", "32", "--batch", "4", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)


def test_trains_checkpoints_and_auto_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    first = train("--device", "cpu", "--steps", "4", "--ckpt-dir", ck,
                  "--ckpt-every", "2")
    assert first.returncode == 0, first.stderr
    assert "auto-resumed" not in first.stdout
    assert first.stdout.strip().splitlines()[-1] == "done"
    assert sorted(os.listdir(ck)) == ["step_2", "step_4"]
    assert all(os.path.exists(os.path.join(ck, d, "COMMIT"))
               for d in os.listdir(ck))

    second = train("--device", "cpu", "--steps", "10", "--ckpt-dir", ck,
                   "--ckpt-every", "100")
    assert second.returncode == 0, second.stderr
    lines = second.stdout.strip().splitlines()
    assert lines[0] == "auto-resumed from step 4"
    assert lines[1].startswith("step    10 loss ")
    assert lines[-1] == "done"
    assert sorted(os.listdir(ck)) == ["step_10", "step_2", "step_4"]


def test_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = train("--steps", "1")
    assert out.returncode != 0
    assert "pass device='cpu'" in out.stderr
