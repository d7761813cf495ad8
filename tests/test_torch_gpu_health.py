"""The port's CUDA preflight (``consensusml_tpu_torch/utils/gpu_health.py``)
against the reference's ``utils/tpu_health.py`` cases: a wedged card is
FAKED through the probe's ``GPU_HEALTH_CMD`` hook (a child that sleeps past
the timeout), so the hang paths run without a card, as the reference's
``TPU_HEALTH_CMD`` tests do."""

import json
import os
import subprocess
import sys

import pytest
import torch

from consensusml_tpu_torch.utils.gpu_health import preflight, probe

pytestmark = pytest.mark.profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE_GPU = ("print('GPU_HEALTH ' + __import__('json').dumps("
            "{'platform': 'cuda', 'n_devices': 1, 'device_kind': 'NVIDIA H100 80GB HBM3'}))")
FAKE_CPU = ("print('GPU_HEALTH ' + __import__('json').dumps("
            "{'platform': 'cpu', 'n_devices': 0, 'device_kind': ''}))")
FAKE_HANG = "import time; time.sleep(600)"
FAKE_CRASH = "import sys; sys.stderr.write('boom'); sys.exit(3)"
FAKE_SILENT = "print('hello')"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_probe_alive_gpu(monkeypatch):
    monkeypatch.setenv("GPU_HEALTH_CMD", FAKE_GPU)
    r = probe(timeout=60)
    assert r["alive"] and r["gpu"] and r["device_kind"] == "NVIDIA H100 80GB HBM3" and r["n_devices"] == 1


def test_probe_alive_cpu_is_not_gpu(monkeypatch):
    monkeypatch.setenv("GPU_HEALTH_CMD", FAKE_CPU)
    r = probe(timeout=60)
    assert r["alive"] and not r["gpu"] and r["platform"] == "cpu"


def test_probe_wedged_card_times_out(monkeypatch):
    monkeypatch.setenv("GPU_HEALTH_CMD", FAKE_HANG)
    r = probe(timeout=1.5)
    assert not r["alive"] and not r["gpu"]
    assert "hanging" in r["reason"] and r["elapsed_s"] < 30  # the caller never hangs


@pytest.mark.parametrize("cmd,reason", [(FAKE_CRASH, "rc=3"), (FAKE_SILENT, "no GPU_HEALTH line")])
def test_probe_crashed_or_silent_child(monkeypatch, cmd, reason):
    monkeypatch.setenv("GPU_HEALTH_CMD", cmd)
    r = probe(timeout=60)
    assert not r["alive"] and reason in r["reason"]
    if cmd == FAKE_CRASH:
        assert "boom" in r["reason"]


def test_the_real_child_on_this_machine():
    """The default child: on a CPU-only machine it runs to its end and finds
    no card (alive, not gpu); with a card, alive and gpu."""
    r = probe(timeout=120)
    assert r["alive"] and r["gpu"] == torch.cuda.is_available()


@pytest.mark.parametrize("cmd,env,rc", [(FAKE_GPU, {}, 0), (FAKE_CPU, {}, 1), (FAKE_HANG, {"GPU_HEALTH_TIMEOUT": "1"}, 2)])
def test_cli_exit_codes(cmd, env, rc):
    r = subprocess.run([sys.executable, "-m", "consensusml_tpu_torch.utils.gpu_health"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "GPU_HEALTH_CMD": cmd, **env})
    assert r.returncode == rc, (r.stdout, r.stderr)
    assert json.loads(r.stdout.strip().splitlines()[-1])["alive"] == (rc != 2)


def test_train_cli_on_a_wedged_card_exits_2_with_the_reason():
    """The train CLI on the card probes before its first CUDA call: a
    wedged card is a clean exit 2 with the diagnostic, not a hang."""
    r = subprocess.run([sys.executable, "-m", "consensusml_tpu_torch.train", "--config", "mnist_mlp"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "GPU_HEALTH_CMD": FAKE_HANG, "GPU_HEALTH_TIMEOUT": "1"})
    assert r.returncode == 2, (r.stdout, r.stderr)
    assert "GPU probe failed" in r.stderr and "hanging" in r.stderr


def test_preflight_skips_and_passes(monkeypatch):
    """Skipped with ``CONSENSUSML_SKIP_GPU_PROBE``; a child that ran and
    found no card is no preflight error (the CLI's own refusal follows); a
    wedged one is."""
    monkeypatch.setenv("GPU_HEALTH_CMD", FAKE_HANG)
    monkeypatch.setenv("GPU_HEALTH_TIMEOUT", "1")
    monkeypatch.setenv("CONSENSUSML_SKIP_GPU_PROBE", "1")
    assert preflight() is None
    monkeypatch.delenv("CONSENSUSML_SKIP_GPU_PROBE")
    assert "GPU probe failed" in preflight()
    monkeypatch.setenv("GPU_HEALTH_CMD", FAKE_CPU)
    assert preflight() is None
