"""PyTorch port: the output writers against the JAX package's.

- The native writers (``hipsc_abm_tpu_torch/native/fastio.cpp``) with more
  chunks than the rows fill evenly: 9 rows in 8 chunks leave chunks 5-7
  past the last row, which must be empty (each runs in a subprocess, since
  an abort would take the test worker with it).
- Values, TDA, gradient and data CSVs byte-equal to the JAX package's
  Python writers on the same arrays (``HIPSC_NO_NATIVE_IO=1`` selects the
  JAX side's Python path).
- Step images equal to the JAX renderer's; the standard-library PNG encoder
  decodes to the same pixels.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from hipsc_abm_tpu.utils import io as jio
from hipsc_abm_tpu_torch import native
from hipsc_abm_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_python_writers(monkeypatch):
    monkeypatch.setenv("HIPSC_NO_NATIVE_IO", "1")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _values_arrays(seed, n):
    rs = np.random.default_rng(seed)
    return {
        "locations": (rs.random((n, 3)) * 2000).astype(np.float32),
        "radii": np.full(n, 5.0, np.float32),
        "GATA6": rs.integers(0, 2, n).astype(np.int32),
        "states": rs.integers(0, 2, n).astype(np.int32),
        "div_counters": rs.integers(0, 72, n).astype(np.int32),
    }


_NATIVE_SCRIPT = """
import sys
import numpy as np
from hipsc_abm_tpu_torch.utils import io
kind, src, out = sys.argv[1:4]
data = dict(np.load(src))
if kind == "values":
    arrays = [data["locations"], data["GATA6"].reshape(-1, 1)]
    header = ["locations[0]", "locations[1]", "locations[2]", "GATA6"]
    assert io._native_values_csv(out, header, arrays, chunks=8)
else:
    assert io._native_savetxt_e18(out, data["locations"][:, :2], chunks=8)
"""


@pytest.mark.parametrize("kind", ["values", "matrix"])
def test_native_writers_with_trailing_empty_chunks(kind, tmp_path, monkeypatch):
    """9 rows in a forced 8 chunks (2 rows per chunk): the writer exits 0
    and writes the Python writer's bytes."""
    arrays = _values_arrays(3, 9)
    src = tmp_path / "in.npz"
    np.savez(src, **arrays)
    out = tmp_path / f"native_{kind}.csv"
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop(native.DISABLE_ENV, None)
    proc = subprocess.run([sys.executable, "-c", _NATIVE_SCRIPT, kind, str(src), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]

    monkeypatch.setenv(native.DISABLE_ENV, "1")
    ref = tmp_path / f"python_{kind}.csv"
    if kind == "values":
        tio.write_values_csv(str(ref), arrays, ["locations", "GATA6"])
    else:
        np.savetxt(ref, arrays["locations"][:, :2].astype(np.float64), delimiter=",")
    assert _read(out) == _read(ref)


@pytest.mark.parametrize("case", ["step", "initial", "ints_only", "special"])
def test_values_csv_bytes_equal_jax(case, tmp_path, jax_python_writers):
    arrays = _values_arrays(5, 200)
    if case == "initial":  # the registered host arrays before the first step
        arrays = {k: v.astype(np.float64 if v.dtype.kind == "f" else np.int64)
                  for k, v in arrays.items()}
    elif case == "ints_only":  # int32 only: both take the csv.writer path
        arrays = {k: v for k, v in arrays.items() if v.dtype.kind == "i"}
    elif case == "special":
        loc = arrays["locations"].astype(np.float64)
        loc[:8, 0] = [np.nan, np.inf, -np.inf, -0.0, 1e-5, 1e17, 123456789012345678.0,
                      5e-324]
        arrays["locations"] = loc
    order = list(arrays)
    tio.write_values_csv(str(tmp_path / "port.csv"), arrays, order)
    jio.write_values_csv(str(tmp_path / "jax.csv"), arrays, order)
    assert _read(tmp_path / "port.csv") == _read(tmp_path / "jax.csv")


def test_tda_gradient_and_data_csvs_bytes_equal_jax(tmp_path, jax_python_writers):
    rs = np.random.default_rng(7)
    n = 150
    locs = (rs.random((n, 3)) * 500).astype(np.float32)
    gata6 = rs.integers(0, 2, n).astype(np.int32)
    nanog = rs.integers(0, 2, n).astype(np.int32)
    grid = rs.random((26, 31)).astype(np.float32)
    times = {"step_fused": 0.25, "step_values": 1e-4, "temp": 3.5e-3}
    for pkg, root in ((tio, tmp_path / "port"), (jio, tmp_path / "jax")):
        root.mkdir()
        pkg.write_tda_csvs(str(root / "tda"), "s", 3, locs, gata6, nanog)
        pkg.write_gradient_csvs(str(root / "grad"), "s", 3, {"fgf4_values": grid})
        for step in (1, 2):
            pkg.append_data_csv(str(root / "s_data.csv"), step, n + step, 0.125 * step,
                                250.5, times)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 5
    for rel in files:
        assert _read(tmp_path / "port" / rel) == _read(tmp_path / "jax" / rel), rel


def test_repr_formatter_matches_python():
    import ctypes

    lib = native.get_lib()
    rs = np.random.default_rng(11)
    values = np.concatenate([
        rs.random(300) * 10.0 ** rs.integers(-12, 20, 300),
        -rs.random(100),
        np.array([0.0, -0.0, 1.0, 0.1, 1e16, 1e15, 9999999999999998.0, 1e-4, 1e-5,
                  np.float32(0.1), 2.0 ** -1074, np.finfo(np.float64).max]),
    ])
    buf = ctypes.create_string_buffer(64)
    for v in values:
        n = lib.hipsc_fmt_repr(float(v), buf)
        assert buf.raw[:n].decode() == repr(float(v))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "fastio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    assert native.get_lib() is None


@pytest.mark.parametrize("color_mode", [True, False])
def test_step_image_equals_jax(color_mode):
    rs = np.random.default_rng(13)
    n = 400
    locs = rs.random((n, 3)) * np.array([300.0, 200.0, 0.0])
    radii = np.where(rs.random(n) < 0.2, 3.6, 5.0)
    states = rs.integers(0, 2, n)
    gata6, nanog = rs.integers(0, 2, n), rs.integers(0, 2, n)
    colors = tio.hipsc_cell_colors(states, gata6, nanog, 2, color_mode)
    np.testing.assert_array_equal(colors,
                                  jio.hipsc_cell_colors(states, gata6, nanog, 2, color_mode))
    args = (locs, radii, colors, (300.0, 200.0, 0.0), 240)
    np.testing.assert_array_equal(tio.render_step_image(*args), jio.render_step_image(*args))


def test_zlib_png_decodes_to_the_same_pixels(tmp_path, monkeypatch):
    import cv2
    from PIL import Image

    rs = np.random.default_rng(17)
    image = rs.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    path = tmp_path / "direct.png"
    path.write_bytes(tio.encode_png(image))
    np.testing.assert_array_equal(cv2.imread(str(path)), image)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")),
                                  image[:, :, ::-1])
    # save_image_png without OpenCV takes the same encoder
    monkeypatch.setattr(tio, "_cv2", lambda: None)
    assert tio.image_encoder() == "zlib"
    tio.save_image_png(str(tmp_path / "fallback.png"), image)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "fallback.png")), image)


def test_video_without_an_encoder_writes_nothing(tmp_path, monkeypatch, capsys):
    frames = tmp_path / "frames"
    frames.mkdir()
    for step in (0, 1):
        tio.save_image_png(str(frames / f"v_image_{step}.png"),
                           np.zeros((8, 8, 3), dtype=np.uint8))
    monkeypatch.setattr(tio, "video_encoder", lambda: None)
    out = tmp_path / "v_video.mp4"
    assert tio.create_video_from_images(str(frames), str(out), 8, 5) is None
    assert not out.exists()
    assert capsys.readouterr().out.count("no video encoder is installed") == 1


def test_output_queue_raises_a_worker_failure():
    def fail():
        raise ValueError("disk full")

    tio.submit_output(fail)
    with pytest.raises(ValueError, match="disk full"):
        tio.flush_outputs()
    tio.flush_outputs()  # the queue is empty again
