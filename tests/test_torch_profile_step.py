"""The decode-step profiler (``repro_torch.launch.profile_step``): its
interval arithmetic on made-up events, and a run on the CPU at a tiny size."""

import pytest

from repro_torch.launch.profile_step import STEP_LABEL, busy_us, main, step_profile


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),            # overlap
    ([(0, 10), (2, 3)], 10.0),             # nested
    ([(20, 30), (0, 10)], 20.0),           # unsorted, disjoint
    ([(0, 10), (10, 12), (11, 20)], 20.0),  # touching, then overlapping
])
def test_busy_us_is_the_union_of_the_intervals(intervals, want):
    assert busy_us(intervals) == want


def test_step_profile_counts_only_events_inside_the_steps():
    steps = [(0.0, 100.0), (200.0, 300.0)]
    kernels = [("gemm", 10.0, 40.0), ("gemm", 30.0, 50.0), ("decode", 210.0, 270.0),
               ("outside", 120.0, 180.0), ("straddles", 90.0, 110.0),
               (STEP_LABEL, 0.0, 100.0)]     # the step's label on the device timeline
    host = [(STEP_LABEL, 0.0, 100.0, 5.0), ("aten::mm", 5.0, 9.0, 4.0),
            ("aten::mm", 205.0, 207.0, 2.0), ("aten::add", 150.0, 160.0, 10.0)]
    got = step_profile(steps, kernels, host)
    assert got["steps"] == 2
    assert got["wall_ms"] == pytest.approx(0.1)
    # step 0: union [10, 50) = 40; step 1: 60 -> 50 us per step
    assert got["device_busy_ms"] == pytest.approx(0.05)
    assert got["device_idle_share"] == pytest.approx(1 - 100 / 200)
    assert got["launches_per_step"] == 1.5
    assert [k["name"] for k in got["kernels"]] == ["decode", "gemm"]
    assert got["kernels"][1]["ms_per_step"] == pytest.approx(0.025)
    assert got["kernels"][1]["calls_per_step"] == 1.0
    assert got["host_ops"] == [{"name": "aten::mm", "self_ms_per_step": pytest.approx(0.003)}]


def test_step_profile_without_device_events_and_without_steps():
    got = step_profile([(0.0, 10.0)], [], [("aten::mm", 1.0, 2.0, 1.0)])
    assert got["device_busy_ms"] == 0.0 and got["device_idle_share"] is None
    with pytest.raises(ValueError):
        step_profile([], [], [])


def test_profile_step_runs_on_the_cpu(capsys):
    out = main(["--arch", "gemma3-1b", "--device", "cpu", "--warmup", "1", "--steps", "2"])
    assert out["steps"] == 2 and out["device"] == "cpu"
    assert out["wall_ms"] > 0 and out["step_ms_unprofiled"] > 0
    assert out["launches_per_step"] == 0 and out["device_idle_share"] is None
    assert any(op["name"].startswith("aten::") for op in out["host_ops"])
    # the batcher's prefills, one a request admitted, each of 200-1400 tokens
    assert out["prefills"] >= 4 and out["prefill_tokens"] >= 200 * out["prefills"]
    assert out["prefill_ms_per_token"] > 0
    assert '"arch": "gemma3-1b' in capsys.readouterr().out


def test_engine_profile_runs_on_the_cpu(capsys):
    """``--engine``: one JSON line an engine, its decode ticks timed and
    profiled (the stepper's decode call, logits on the host)."""
    out = main(["--engine", "dense", "paged", "--device", "cpu", "--warmup", "2",
                "--steps", "3"])["engines"]
    assert [o["engine"] for o in out] == ["dense", "paged"]
    for o in out:
        assert o["steps"] == 3 and o["device"] == "cpu" and o["n_layers"] == 2
        assert o["steps_unprofiled"] == o["decode_ticks"] - 3 > 0
        assert o["wall_ms"] > 0 and o["step_ms_unprofiled"] > 0
        assert o["device_idle_share"] is None
        assert any(op["name"].startswith("aten::") for op in o["host_ops"])
    assert capsys.readouterr().out.count('"engine": ') == 2
