"""The port's ft/ watchdogs and coordinator against the JAX package's, on the
CPU: tests/test_ft_watchdog.py's call sequences driven through both
packages' StepWatchdog and HangDetector with one fake clock (the port's
``ft.watchdog`` clock monkeypatched, as that file does), comparing every
flag and callback; the Coordinator's membership and generation numbers
under the same register / heartbeat / sweep sequence; and
plan_mesh_after_failure.  One test lets a HangDetector Timer thread fire
for real."""

import threading
import time

import pytest

import repro  # noqa: F401
from repro.ft import coordinator as jcoord
from repro.ft import watchdog as jwd
from repro_torch.ft import coordinator as tcoord
from repro_torch.ft import watchdog as twd

PACKAGES = [pytest.param(jwd, id="jax"), pytest.param(twd, id="port")]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _FakeClock()
    monkeypatch.setattr("repro_torch.ft.watchdog.time.perf_counter", c)
    # both modules read the one `time` module, so the JAX package's sees it too
    assert jwd.time.perf_counter is c
    return c


def _step(wd, clock, dt):
    wd.start()
    clock.t += dt
    return wd.stop()


def _both(fn):
    """Run ``fn(module)`` on the JAX package's watchdog module and the
    port's; assert equal results and return the port's."""
    j, t = fn(jwd), fn(twd)
    assert t == j
    return t


# --------------------------------------------------------------------------- #
# StepWatchdog
# --------------------------------------------------------------------------- #

def test_no_flag_before_five_samples(clock):
    def run(m):
        wd = m.StepWatchdog(threshold=2.0)
        flags = [_step(wd, clock, dt) for dt in (1.0, 1.0, 1.0, 1.0, 100.0, 100.0)]
        return flags, wd.stragglers
    assert _both(run) == ([False] * 5 + [True], [6])


def test_threshold_boundary_is_strict(clock):
    def run(m):
        wd = m.StepWatchdog(threshold=2.0)
        for _ in range(5):
            _step(wd, clock, 1.0)
        return _step(wd, clock, 2.0), _step(wd, clock, 2.0 + 1e-9), wd.stragglers
    assert _both(run) == (False, True, [7])


def test_window_eviction_shifts_median(clock):
    def run(m):
        wd = m.StepWatchdog(window=6, threshold=2.0)
        for _ in range(6):
            _step(wd, clock, 1.0)
        med0 = wd.median
        for _ in range(6):
            _step(wd, clock, 10.0)
        return med0, wd.median, len(wd._times), _step(wd, clock, 10.0)
    assert _both(run) == (1.0, 10.0, 6, False)


@pytest.mark.parametrize("m", PACKAGES)
def test_start_required_before_stop(m, clock):
    with pytest.raises(AssertionError):
        m.StepWatchdog().stop()


def test_step_numbering_across_flags(clock):
    def run(m):
        wd = m.StepWatchdog(threshold=2.0)
        for dt in [1.0] * 5 + [5.0] + [1.0] * 3 + [5.0]:
            _step(wd, clock, dt)
        return wd.stragglers
    assert _both(run) == [6, 10]


# --------------------------------------------------------------------------- #
# HangDetector — fake clock, no sleeps
# --------------------------------------------------------------------------- #

def test_overrun_detected_even_when_timer_never_ran(clock):
    def run(m):
        fired = []
        hd = m.HangDetector(10.0, lambda: fired.append(1))
        with hd:
            clock.t += 11.0                 # overrun, Timer still pending
        return hd.fired, fired, hd._timer
    assert _both(run) == (True, [1], None)


def test_disarm_before_deadline_never_fires(clock):
    def run(m):
        fired = []
        hd = m.HangDetector(10.0, lambda: fired.append(1))
        with hd:
            clock.t += 9.0
        return hd.fired, fired, hd._timer
    assert _both(run) == (False, [], None)


def test_back_to_back_overruns_each_fire_once(clock):
    def run(m):
        fired = []
        hd = m.HangDetector(10.0, lambda: fired.append(len(fired) + 1))
        flags = []
        for dt in (11.0, 11.0, 1.0):
            with hd:
                clock.t += dt
            flags.append(hd.fired)
        return flags, fired
    assert _both(run) == ([True, True, False], [1, 2])


def test_stale_timer_fire_cannot_corrupt_next_arm(clock):
    def run(m):
        fired = []
        hd = m.HangDetector(10.0, lambda: fired.append(1))
        with hd:
            stale_fire = hd._timer.function     # arm 1's pending callback
            clock.t += 1.0
        flags = [hd.fired]
        with hd:
            stale_fire()                        # arm 1's Timer runs late
            flags.append(hd.fired)
            clock.t += 1.0
        return flags + [hd.fired], fired
    assert _both(run) == ([False, False, False], [])


def test_exit_and_timer_agree_on_single_fire(clock):
    def run(m):
        fired = []
        hd = m.HangDetector(10.0, lambda: fired.append(1))
        with hd:
            timer_fire = hd._timer.function
            clock.t += 11.0
            timer_fire()                        # Timer beats __exit__
            mid = hd.fired
        return mid, fired
    assert _both(run) == (True, [1])


@pytest.mark.parametrize("m", PACKAGES)
def test_timer_thread_fires_once_for_real(m):
    """The one real-clock case: a step that sleeps past a real deadline
    fires exactly once, whichever of the Timer thread and __exit__ gets
    there first, and nothing fires after the step (re-arming is the fake
    clock's business above: a real one could stall past any deadline)."""
    fired = []
    hd = m.HangDetector(0.02, lambda: fired.append(threading.get_ident()))
    with hd:
        time.sleep(0.1)
    time.sleep(0.05)
    assert hd.fired and len(fired) == 1 and hd._timer is None


# --------------------------------------------------------------------------- #
# Coordinator and plan_mesh_after_failure
# --------------------------------------------------------------------------- #

class _Mono:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_coordinator_membership_matches_jax(monkeypatch):
    mono = _Mono()
    monkeypatch.setattr("repro_torch.ft.coordinator.time.monotonic", mono)

    def run(m):
        c = m.Coordinator(deadline=1.0)
        log = [c.register("a"), c.register("b"), c.alive(), c.generation]
        mono.t += 0.5
        c.heartbeat("a")
        mono.t += 0.8                       # b is 1.3 s stale, a 0.8 s
        log += [c.sweep(), c.alive(), c.generation, c.sweep(), c.generation]
        log.append(c.register("b"))         # a restart is a membership event
        log += [c.alive(), c.generation]
        with pytest.raises(KeyError):
            c.heartbeat("nobody")
        return log

    assert _both_coord(run) == [1, 2, ["a", "b"], 2, ["b"], ["a"], 3, [], 3, 4,
                                ["a", "b"], 4]


def _both_coord(fn):
    j, t = fn(jcoord), fn(tcoord)
    assert t == j
    return t


@pytest.mark.parametrize("alive,mp", [(64, 16), (47, 16), (15, 16), (8, 8), (9, 1)])
def test_plan_mesh_after_failure_matches_jax(alive, mp):
    assert tcoord.plan_mesh_after_failure(alive, mp) == \
        jcoord.plan_mesh_after_failure(alive, mp)
