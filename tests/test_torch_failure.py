"""The port's failure plane (``sherman_tpu_torch/utils/failure.py``)
against the reference's (``sherman_tpu/utils/failure.py``), the fast cases
of ``tests/test_failure.py``: the watchdog's timing, disarming, env gating
and diagnostics, the ``PeerFailure`` surface and the single-process
parity of the guarded surfaces, each run on both packages with the same
expectations.  The process cases (stall, death, preemption) are in
``tests/test_torch_multiprocess.py``."""

import signal
import time

import pytest

from sherman_tpu.utils import failure as JF
from sherman_tpu_torch.utils import failure as TF

BOTH = pytest.mark.parametrize("F", [JF, TF], ids=["jax", "port"])


@BOTH
def test_watchdog_fires_while_blocked(F):
    fired, diags = [], []
    wd = F.Watchdog(0.15, what="unit block",
                    action=lambda: fired.append(time.monotonic()),
                    diagnostics=lambda: diags.append(1) or "snap")
    t0 = time.monotonic()
    with wd:
        time.sleep(0.6)
    assert wd.fired and fired and fired[0] - t0 < 0.5
    assert diags, "diagnostics callback not invoked"
    assert F.Watchdog.EXIT_CODE == 86


@BOTH
def test_watchdog_disarms_on_clean_exit(F):
    fired = []
    with F.Watchdog(0.2, action=lambda: fired.append(1)):
        pass
    time.sleep(0.4)
    assert not fired


@BOTH
def test_watchdog_diagnostics_failure_does_not_mask(F, capsys):
    def boom():
        raise ValueError("diag broke")

    with F.Watchdog(0.05, what="diag-fail", action=lambda: None,
                    diagnostics=boom) as wd:
        time.sleep(0.3)
    assert wd.fired
    err = capsys.readouterr().err
    assert "diag-fail" in err and "diagnostics failed" in err


def test_watchdog_messages_match(capsys):
    """The two packages print the same deadline and diagnostics lines."""
    lines = []
    for F in (JF, TF):
        with F.Watchdog(0.05, what="same", action=lambda: None,
                        diagnostics=lambda: {"a": 1}):
            time.sleep(0.3)
        lines.append(capsys.readouterr().err)
    assert lines[0] == lines[1] and "'same' exceeded 0.05s" in lines[0]


def test_watchdog_fired_event_recorded():
    """A firing records ``watchdog.fired`` in the port's flight ring."""
    from sherman_tpu_torch.obs import recorder as FR
    FR.get_recorder().clear()
    with TF.Watchdog(0.05, what="ev", action=lambda: None):
        time.sleep(0.3)
    evs = [e for e in FR.get_recorder().events()
           if e["kind"] == "watchdog.fired"]
    assert evs and evs[-1]["fields"]["what"] == "ev"


@BOTH
def test_watchdog_maybe_env_gating(F, monkeypatch):
    monkeypatch.delenv("SHERMAN_COLLECTIVE_TIMEOUT_S", raising=False)
    wd = F.Watchdog.maybe()
    assert wd.timeout_s == 0
    with wd:
        assert wd._timer is None
    monkeypatch.setenv("SHERMAN_COLLECTIVE_TIMEOUT_S", "7.5")
    assert F.Watchdog.maybe().timeout_s == 7.5
    monkeypatch.setenv("SHERMAN_COLLECTIVE_TIMEOUT_S", "2m")
    with pytest.raises(ValueError, match="SHERMAN_COLLECTIVE_TIMEOUT_S"):
        F.Watchdog.maybe()


def test_watchdog_knob_error_matches(monkeypatch):
    monkeypatch.setenv("SHERMAN_COLLECTIVE_TIMEOUT_S", "soon")
    msgs = []
    for F in (JF, TF):
        with pytest.raises(ValueError) as e:
            F.Watchdog.maybe()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@BOTH
def test_preemption_guard_single_process_latch(F):
    prev = signal.getsignal(signal.SIGTERM)
    guard = F.PreemptionGuard()
    try:
        assert not guard.should_act(0)
        signal.raise_signal(signal.SIGTERM)
        assert guard.should_act(1)
        assert guard.should_act(2), "latch must stay set"
    finally:
        guard.close()
    assert signal.getsignal(signal.SIGTERM) is prev


@BOTH
def test_peer_failure_surface(F):
    e = F.PeerFailure("gone", missing=(3, 1), attempt=4)
    assert e.missing == [1, 3] and e.attempt == 4
    assert isinstance(e, RuntimeError)


@BOTH
def test_single_process_parity(F):
    """Outside a multi-process group the guarded surfaces are trivially
    met, and the in-process Keeper takes ``timeout_s``."""
    if F is JF:
        from sherman_tpu.parallel.bootstrap import Keeper
    else:
        from sherman_tpu_torch.parallel.bootstrap import Keeper
    assert F.coordination_client() is None
    assert F.live_processes(4) == [0, 1, 2, 3]
    assert F.barrier_guarded("solo", 1.0, attempt=3) == 3
    Keeper(2).barrier("solo", timeout_s=1.0)


def test_no_heartbeat_outside_a_group():
    assert TF.start_heartbeat(3) is None
    assert TF.heartbeat_monitor() is None
