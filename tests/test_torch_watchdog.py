"""The round watchdog (``consensusml_tpu_torch/utils/watchdog.py``): it
fires through an injected ``exit_fn`` with code 3 once armed and stalled,
never before its first beat, never while paused, and its timeout must be
positive. Timeouts of 0.1-0.3 s keep the file under a few seconds."""

import threading
import time

import pytest

from consensusml_tpu_torch.utils.watchdog import ProgressWatchdog


def _watch(timeout, **kw):
    fired, hooked = threading.Event(), []
    codes = []

    def exit_fn(code):
        codes.append(code)
        fired.set()

    dog = ProgressWatchdog(timeout, exit_fn=exit_fn, on_timeout=hooked.append, **kw).start()
    return dog, fired, codes, hooked


def test_fires_after_a_stalled_round_with_exit_code_3(capfd):
    dog, fired, codes, hooked = _watch(0.2)
    time.sleep(0.5)
    assert not fired.is_set()  # not armed before the first beat
    dog.beat("round 0")
    assert fired.wait(3.0) and codes == [3]
    assert hooked and hooked[0].startswith("watchdog-timeout: no train round progress")
    assert "last progress: round 0" in capfd.readouterr().err
    dog.stop()


def test_beats_and_pause_keep_it_quiet():
    dog, fired, codes, _ = _watch(0.3)
    for r in range(6):
        dog.beat(f"round {r}")
        time.sleep(0.1)
    dog.pause()  # an eval: no per-round budget
    time.sleep(0.8)
    assert not fired.is_set()
    dog.beat("eval done")
    time.sleep(0.1)
    dog.stop()
    time.sleep(0.5)
    assert not fired.is_set() and codes == []


def test_armed_from_the_start_and_checks():
    dog, fired, codes, _ = _watch(0.1, arm_on_first_beat=False, exit_code=7)
    assert fired.wait(3.0) and codes == [7]
    dog.stop()
    with pytest.raises(ValueError, match="positive"):
        ProgressWatchdog(0)
