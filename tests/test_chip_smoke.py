"""chip_smoke.py's phases at tiny sizes on the CPU (the GPU kernel in
interpret mode), and its refusal to report without a GPU."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

from conftest import needs_devices  # noqa: E402


@pytest.fixture
def rep(capsys):
    return cs.Report("cpu-test")


def test_refined_sqrt_phase(rep):
    cs.phase_refined_sqrt(rep, bits=16)


def test_cli_and_kernel_phases(rep, tmp_path, capsys):
    ref = cs.phase_cli_exact(rep, str(tmp_path), size=96, spreads=(5, 40), oracle_size=40)
    cs.phase_kernel_vs_xla(rep, ref["image"], spreads=(5, 40), interpret=True)
    cs.phase_brute_jfa(rep, str(tmp_path), ref["image"], ref["merged"], spread=8,
                       window=16)
    out = capsys.readouterr().out
    for phase in ("cli_exact_s5", "cli_exact_s40", "cli_readme", "hard_triton_s40",
                  "exact_field_triton", "cli_brute_s8", "cli_jfa_s8"):
        assert f"[{phase}]" in out, phase
    assert "compile_s=" in out and "memory=" in out and "core=xla" in out


def test_atlas_phase(rep):
    cs.phase_atlas(rep, batch=2, size=40, sweep_size=64, spreads=(4, 9, 20))


def test_soft_phase(rep, capsys):
    cs.phase_soft(rep, size=128, spread=9)
    out = capsys.readouterr().out
    assert "[soft_precision_high]" in out and "grad_max_err_over_scale=" in out


def test_train_phase(rep):
    losses = cs.phase_train(rep, batch=2, size=32, steps=4)
    assert losses[-1] < losses[0]


def test_four_phase_on_virtual_devices(rep, tmp_path, capsys):
    needs_devices(4)
    cs.phase_four(rep, str(tmp_path), size=64, atlas_size=32, train_size=32)
    out = capsys.readouterr().out
    assert out.count("shard_devices=") == 3


def test_check_raises():
    with pytest.raises(cs.CheckFailed):
        cs.check(False, "x")


def test_main_refuses_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert cs.main([]) == 1
    captured = capsys.readouterr()
    assert "no GPU" in captured.err
    assert not captured.out.strip()


def test_lone_script_fails(tmp_path):
    """Copied alone into an empty directory, the script finds no package
    and exits non-zero without a result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_brute_window_reference_matches_whole_image_oracle():
    """A window plus a spread-wide margin gives the oracle's bytes for the
    whole image inside the window, at a corner and in the middle."""
    from sdfref import oracle
    from sdfref.samples import glyph_image

    img = glyph_image(5, (60, 70))
    full = oracle.sdf_pipeline_opencl(img, spread=6)
    for y0, x0 in ((0, 0), (20, 30), (44, 54)):
        np.testing.assert_array_equal(
            cs.brute_window_reference(img, 6, y0, x0, 16), full[y0 : y0 + 16, x0 : x0 + 16]
        )
