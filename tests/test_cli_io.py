"""CLI + image I/O: end-to-end golden run, flag handling, filetype
resolution, stdin/stdout streaming."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from chaq_sdfgen.cli import main
from chaq_sdfgen.utils import imageio as iio


def test_cli_golden_end_to_end(tmp_path, sample_golden, sample):
    out = tmp_path / "out.png"
    rc = main(["-i", sample.input, "-o", str(out), "-s", "100", "-a", "-l"])
    assert rc == 0
    got = np.asarray(Image.open(out))
    np.testing.assert_array_equal(got, sample_golden)


def test_cli_combined_short_flags(tmp_path, sample_golden, sample):
    out = tmp_path / "out2.png"
    rc = main(["-i", sample.input, "-o", str(out), "-s", "100", "-al"])
    assert rc == 0
    got = np.asarray(Image.open(out))
    np.testing.assert_array_equal(got, sample_golden)


def test_cli_validation_errors(tmp_path, sample):
    assert main(["-i", sample.input, "-s", "10"]) == 1  # no output
    assert main(["-o", str(tmp_path / "x.png")]) == 1  # no input
    assert main(["-i", sample.input, "-o", "x.png", "-q", "0"]) == 1
    assert main(["-i", sample.input, "-o", "x.png", "-q", "101"]) == 1
    assert main(["-i", sample.input, "-o", "x.png", "-s", "0"]) == 1
    assert main(["-i", "/nonexistent.png", "-o", "x.png"]) == 1


def test_cli_algorithms_agree(tmp_path, sample):
    outs = {}
    for algo in ("exact", "jfa"):
        out = tmp_path / f"{algo}.png"
        rc = main(["-i", sample.input, "-o", str(out), "-s", "16", "-l", "--algorithm", algo])
        assert rc == 0
        outs[algo] = np.asarray(Image.open(out)).astype(int)
    diff = np.abs(outs["exact"] - outs["jfa"])
    assert (diff == 0).mean() > 0.995


def test_filetype_resolution():
    assert iio.deduce_filetype("x.png") == "png"
    assert iio.deduce_filetype("x.bmp") == "bmp"
    # strncmp(ext, "jpg", 3) does NOT match "jpeg" -> png fallback
    # (openmp/sdfgen.c:108-115); the OpenCL-style resolver does match it
    assert iio.deduce_filetype("x.jpeg") == "png"
    assert iio.deduce_filetype("x.jpg") == "jpg"
    assert iio.deduce_filetype("x.tga") == "tga"
    assert iio.deduce_filetype("noext") == "png"
    assert iio.deduce_filetype("x.webp") == "png"  # unknown -> png fallback
    assert iio.deduce_filetype("x.png", explicit="bmp") == "bmp"
    assert iio.filetype_from_str_opencl("JPEG") == "jpg"
    assert iio.filetype_from_str_opencl("something.tga") == "tga"
    assert iio.filetype_from_str_opencl("???") == "png"


@pytest.mark.parametrize("ft", ["png", "bmp", "tga", "jpg"])
def test_write_read_roundtrip(tmp_path, ft):
    rng = np.random.default_rng(0)
    img = (rng.random((20, 30)) * 255).astype(np.uint8)
    path = tmp_path / f"img.{ft}"
    iio.write_gray(img, str(path), quality=100)
    back = iio.load_gray_alpha(str(path))
    assert back.shape == (20, 30, 2)
    if ft != "jpg":  # jpeg is lossy
        np.testing.assert_array_equal(back[..., 0], img)


def test_rgba_luminance_matches_stb_formula(tmp_path):
    rng = np.random.default_rng(1)
    rgba = (rng.random((8, 8, 4)) * 255).astype(np.uint8)
    p = tmp_path / "c.png"
    Image.fromarray(rgba, "RGBA").save(p)
    out = iio.load_gray_alpha(str(p))
    r, g, b = rgba[..., 0].astype(int), rgba[..., 1].astype(int), rgba[..., 2].astype(int)
    want = ((r * 77 + g * 150 + 29 * b) >> 8).astype(np.uint8)
    np.testing.assert_array_equal(out[..., 0], want)
    np.testing.assert_array_equal(out[..., 1], rgba[..., 3])


def test_stdout_streaming(tmp_path, sample_golden, monkeypatch, capsysbinary, sample):
    rc = main(["-i", sample.input, "-o", "-", "-s", "100", "-al"])
    assert rc == 0
    data = capsysbinary.readouterr().out
    got = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(got, sample_golden)


def test_cli_list_platforms(capsys):
    assert main(["--list-platforms"]) == 0
    assert capsys.readouterr().out.strip()


def test_cli_platform_selection(tmp_path, sample_golden, capsys, sample):
    # select by case-insensitive name substring (opencl/main.cpp:493-538)
    out = tmp_path / "plat.png"
    rc = main(["-i", sample.input, "-o", str(out), "-s", "100", "-al", "--platform", "CP"])
    assert rc == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)), sample_golden)
    # no-match -> reference error message + failure exit
    assert main(["-i", sample.input, "-o", str(out), "--platform", "vulkan"]) == 1
    assert "Platform specified not found." in capsys.readouterr().err
    # --list-devices honors the selected platform
    assert main(["--platform", "cpu", "--list-devices"]) == 0
    listing = capsys.readouterr().out
    assert listing.strip() and "cpu" in listing.lower()


def test_cli_time_flag_reports_kernel_seconds(tmp_path, capsys, sample):
    out = tmp_path / "timed.png"
    rc = main(["-i", sample.input, "-o", str(out), "-s", "16", "-l", "--time"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "Kernel timing:" in err and "sec" in err


def test_cli_device_selection(tmp_path, sample_golden, sample):
    out = tmp_path / "dev.png"
    rc = main(["-i", sample.input, "-o", str(out), "-s", "100", "-al", "--device", "0"])
    assert rc == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)), sample_golden)
    assert main(["-i", sample.input, "-o", str(out), "--device", "99"]) == 1
    assert main(["-i", sample.input, "-o", str(out), "--device", "nonexistent-kind"]) == 1


def test_cli_two_channel_output(tmp_path, sample):
    out = tmp_path / "la.png"
    rc = main(["-i", sample.input, "-o", str(out), "-s", "16", "-l", "--algorithm", "brute",
               "--two-channel"])
    assert rc == 0
    im = Image.open(out)
    assert im.mode == "LA"
    arr = np.asarray(im)
    assert (arr[..., 1] == 255).all()


def test_cli_soft_roundtrip(tmp_path):
    """--soft: the differentiable pipeline is flag-
    reachable; output is the clamped soft byte map, converging to the
    hard map as tau -> 0 with T/tau -> inf (the indicator heights cap
    soft distances at sqrt(T * |logit|_max), so tau must shrink faster
    than T for the cap to clear the spread)."""
    from PIL import Image as PILImage

    img = np.zeros((64, 64), np.uint8)
    img[20:44, 20:44] = 255
    inp = tmp_path / "in.png"
    PILImage.fromarray(img).save(inp)
    out = tmp_path / "soft.png"
    rc = main([
        "-i", str(inp), "-o", str(out), "-s", "12", "-l", "--soft",
        "--soft-tau", "0.01", "--soft-temperature", "0.1",
    ])
    assert rc == 0
    soft = np.asarray(Image.open(out)).astype(int)
    hard_out = tmp_path / "hard.png"
    assert main(["-i", str(inp), "-o", str(hard_out), "-s", "12", "-l"]) == 0
    hard = np.asarray(Image.open(hard_out)).astype(int)
    assert soft.shape == hard.shape
    # near the hard limit the two byte maps agree almost everywhere
    assert (np.abs(soft - hard) <= 2).mean() > 0.97


def test_cli_soft_field_dump(tmp_path):
    from PIL import Image as PILImage

    img = np.zeros((64, 64), np.uint8)
    img[20:44, 20:44] = 255
    inp = tmp_path / "in.png"
    PILImage.fromarray(img).save(inp)
    out = tmp_path / "soft.png"
    field_path = tmp_path / "field.npy"
    rc = main([
        "-i", str(inp), "-o", str(out), "-s", "8", "-l", "--soft",
        "--soft-field", str(field_path),
    ])
    assert rc == 0
    field = np.load(field_path)
    assert field.shape == img.shape
    assert field.dtype == np.float32
    assert np.isfinite(field).all()
    # signed: positive at shape (TRUE) pixels, negative outside
    assert (field > 0).any() and (field < 0).any()


def test_cli_soft_field_requires_soft(tmp_path, sample):
    rc = main(["-i", sample.input, "-o", str(tmp_path / "x.png"),
               "--soft-field", str(tmp_path / "f.npy")])
    assert rc == 1


def test_cli_sharded_run_matches_unsharded(tmp_path, sample):
    """--shard-y routes through ShardingConfig -> sharded_hard_sdf_bytes;
    bytes identical to the unsharded run."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    out_s = tmp_path / "sharded.png"
    # sample is 200x200; 2-way row sharding -> 100-row shards
    rc = main(["-i", sample.input, "-o", str(out_s), "-s", "100", "-al", "--shard-y", "2"])
    assert rc == 0
    got = np.asarray(Image.open(out_s))
    want = np.asarray(Image.open(sample.output))
    np.testing.assert_array_equal(got, want)


def test_cli_soft_prec_high(tmp_path):
    """--soft-prec passes the cascade's matmul precision explicitly: 'high'
    tracks the default 'highest' output to a couple of byte levels, and
    an in-process run leaves no state behind (a later default run gives
    the same bytes as the first)."""
    from PIL import Image as PILImage

    img = np.zeros((64, 64), np.uint8)
    img[20:44, 20:44] = 255
    inp = tmp_path / "in.png"
    PILImage.fromarray(img).save(inp)
    out_hi = tmp_path / "hi.png"
    out_3p = tmp_path / "3p.png"
    out_again = tmp_path / "again.png"
    assert main(["-i", str(inp), "-o", str(out_hi), "-s", "12", "-l",
                 "--soft"]) == 0
    assert main(["-i", str(inp), "-o", str(out_3p), "-s", "12", "-l",
                 "--soft", "--soft-prec", "high"]) == 0
    assert main(["-i", str(inp), "-o", str(out_again), "-s", "12", "-l",
                 "--soft"]) == 0
    hi = np.asarray(Image.open(out_hi)).astype(int)
    p3 = np.asarray(Image.open(out_3p)).astype(int)
    again = np.asarray(Image.open(out_again)).astype(int)
    assert np.abs(hi - p3).max() <= 2
    np.testing.assert_array_equal(again, hi)


def test_cli_rejects_sharded_brute(tmp_path, sample, capsys):
    """BRUTE has no sharded pipeline: the CLI refuses --shard-y with it
    before reading the input."""
    rc = main(["-i", "/nonexistent.png", "-o", str(tmp_path / "x.png"),
               "--algorithm", "brute", "--shard-y", "2"])
    assert rc == 1
    assert "no sharded pipeline" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--shard-x", "2"], ["--halo-impl", "rdma"]])
def test_cli_removed_options_rejected(tmp_path, sample, argv):
    with pytest.raises(SystemExit):
        main(["-i", sample.input, "-o", str(tmp_path / "x.png")] + argv)
