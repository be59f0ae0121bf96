"""The port's training driver (``python -m repro_torch.launch.train``)
against the JAX package's (``python -m repro.launch.train``) on the CPU.

Both runs use ``--reduced --steps 6`` (the schedule, warmup_cosine(lr, 20,
steps), depends on ``--steps``) with ``--ckpt-interval 3``.  JAX's driver
writes steps 3 and 6; its step 6 is kept aside and taken out of the
directory.  The port's driver, with ``--device cpu``, resumes from JAX's
step 3 and writes its own step 6, which must hold JAX's keys and dtypes
and match JAX's uninterrupted step 6 within 1e-5 in every leaf, params
and optimizer state alike (the lr is at most 3e-4 in these steps, so
Adam's normalised update cannot amplify a last-bit gradient difference
past that; seen: 3e-8).  The log lines are JAX's: the same header, a
``resumed from step 3`` line, per-step lines (``--log-interval 1``) with
the same loss, lr and grad norm, and the same final loss.  Without
``--device`` the driver needs a card and says so.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--reduced", "--steps", "6", "--ckpt-interval", "3", "--log-interval", "1"]
STEP_LINE = re.compile(r"step\s+(\d+) loss (\S+) lr (\S+) gnorm (\S+) ")


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_port_driver_resumes_jax_driver_and_matches_its_run(tmp_path):
    ckpt = tmp_path / "ckpt"
    jout = _run("repro.launch.train", *ARGS, "--ckpt-dir", str(ckpt))
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006"]
    shutil.move(str(ckpt / "step_00000006"), str(tmp_path / "jax_step6"))
    out = _run("repro_torch.launch.train", *ARGS, "--ckpt-dir", str(ckpt), "--device", "cpu")
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006"]

    want, got = _npz(tmp_path / "jax_step6"), _npz(ckpt / "step_00000006")
    assert list(got) == list(want)
    assert any(k.startswith("opt/master/") for k in got) and "opt/step" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["opt/step"]) == 6

    jlines, lines = jout.stdout.splitlines(), out.stdout.splitlines()
    assert lines[0] == jlines[0]                       # arch, params, steps, batch
    assert lines[1] == "resumed from step 3"
    jsteps = {int(m[1]): m for m in map(STEP_LINE.match, jlines) if m}
    steps = {int(m[1]): m for m in map(STEP_LINE.match, lines) if m}
    assert sorted(jsteps) == list(range(1, 7)) and sorted(steps) == [4, 5, 6]
    for i, m in steps.items():
        j = jsteps[i]
        assert abs(float(m[2]) - float(j[2])) <= 2e-4 and m[3] == j[3], (m[0], j[0])
        assert abs(float(m[4]) - float(j[4])) <= 0.011, (m[0], j[0])
    final, jfinal = lines[-1], jlines[-1]
    assert final.startswith("final loss ") and final.split(" (")[0] == jfinal.split(" (")[0]


def _main(monkeypatch, *args):
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", ["repro_torch.launch.train", *args])
    train.main()


def test_driver_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(monkeypatch, "--reduced", "--steps", "1")


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_driver_trains_the_frontends_on_the_cpu(arch, monkeypatch, capsys):
    """The encoder-decoder's ``src_embeds`` and pixtral's ``embeds`` batches,
    as JAX's driver builds them."""
    _main(monkeypatch, "--arch", arch, "--reduced", "--steps", "2", "--batch", "2", "--seq",
          "16", "--device", "cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch}-reduced ")
    assert lines[-1].startswith("final loss ")
