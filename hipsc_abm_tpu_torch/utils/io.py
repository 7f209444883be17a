"""Output suite (port of ``hipsc_abm_tpu/utils/io.py``): per-step CSVs,
step images, video, TDA and gradient files.

The CSV writers give the bytes of the JAX package's writers: values CSVs
through ``csv.writer`` (or the native writer, ``native/fastio.cpp``, byte
for byte the same), TDA and gradient CSVs as ``np.savetxt(fmt='%.18e')``.
Step images are rendered by the vectorized circle stamp and written as PNG
by OpenCV when it is installed, else by a PNG encoder on the standard
library's ``zlib`` (same pixels). Video uses OpenCV, then imageio; with
neither installed it prints one line and writes no mp4.
"""

from __future__ import annotations

import csv
import ctypes
import math
import os
import re
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hipsc_abm_tpu_torch import native
from hipsc_abm_tpu_torch.utils.config import check_direct

# ---------------------------------------------------------------------------
# optional encoders
# ---------------------------------------------------------------------------


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def image_encoder() -> str:
    """The PNG encoder ``save_image_png`` uses: ``"cv2"`` or ``"zlib"``."""
    return "cv2" if _cv2() is not None else "zlib"


def video_encoder() -> Optional[str]:
    """The mp4 encoder ``create_video_from_images`` uses: ``"cv2"``,
    ``"imageio"``, or None when neither is installed."""
    if _cv2() is not None:
        return "cv2"
    try:
        import imageio.v2  # noqa: F401
    except ImportError:
        return None
    return "imageio"


# ---------------------------------------------------------------------------
# CSV outputs
# ---------------------------------------------------------------------------


def _native_values_csv(path: str, header: List[str], data: List[np.ndarray],
                       chunks: int = 0) -> bool:
    """Native values CSV (byte-identical to the csv.writer path, which
    stringifies the float64-upcast hstack with CRLF rows). Taken when that
    upcast is float64 and no header needs csv quoting; returns False
    otherwise. ``chunks`` > 0 forces the writer's chunk count."""
    lib = native.get_lib()
    if lib is None:
        return False
    if np.result_type(*[a.dtype for a in data]) != np.float64:
        return False  # the Python path would print another dtype's repr
    if any(ch in h for h in header for ch in (",", '"', "\r", "\n")):
        return False  # csv.writer would quote these
    cols = [np.ascontiguousarray(a[:, i], dtype=np.float64)
            for a in data for i in range(a.shape[1])]
    nrows = cols[0].shape[0] if cols else 0
    ptrs = (ctypes.c_void_p * len(cols))(*[c.ctypes.data for c in cols])
    rc = lib.hipsc_write_values_csv(path.encode(), ",".join(header).encode(), nrows,
                                    len(cols), ptrs, int(chunks))
    if rc != 0:
        raise OSError(f"native values writer failed on {path} (rc {rc})")
    return True


def write_values_csv(path: str, arrays: Dict[str, np.ndarray], order: Sequence[str]) -> None:
    """Agent-array CSV, one row per agent: 1-D arrays get one column named
    after the array; 2-D arrays get ``name[i]`` columns."""
    header: List[str] = []
    data: List[np.ndarray] = []
    for array_name in order:
        agent_array = np.asarray(arrays[array_name])
        if agent_array.ndim == 1:
            agent_array = agent_array.reshape(-1, 1)
            header.append(array_name)
        else:
            header.extend(f"{array_name}[{i}]" for i in range(agent_array.shape[1]))
        data.append(agent_array)

    if data and _native_values_csv(path, header, data):
        return
    with open(path, "w", newline="") as file:
        writer = csv.writer(file)
        writer.writerow(header)
        writer.writerows(np.hstack(data))


def merge_sharded_values(dir_path: str, name: str, step: int,
                         out_path: Optional[str] = None,
                         n_shards: Optional[int] = None) -> str:
    """Concatenate the per-tile value CSVs ``{name}_values_{step}.shard{s}.csv``
    (``DomainHipscEngine.write_values_sharded``, each written by the process
    that holds the tile) in tile order into the one-file format: the first
    shard's header, then every shard's rows, byte for byte. A missing tile
    raises: an interior gap always, a trailing one when ``n_shards`` (the
    engine's tile count) is given."""
    import shutil

    pattern = re.compile(rf"^{re.escape(name)}_values_{step}\.shard(\d+)\.csv$")
    shards = sorted((int(m.group(1)), f) for f in os.listdir(dir_path)
                    if (m := pattern.match(f)))
    if not shards:
        raise FileNotFoundError(f"no {name}_values_{step}.shard*.csv under {dir_path}")
    indices = [s for s, _ in shards]
    expected = list(range(n_shards if n_shards is not None else len(indices)))
    if indices != expected:
        raise FileNotFoundError(f"{name}_values_{step} shard set is incomplete: found "
                                f"{indices}, expected {expected} under {dir_path}")
    out_path = out_path or os.path.join(dir_path, f"{name}_values_{step}.csv")
    # binary copy: the rows keep the writer's CRLF endings
    with open(out_path, "wb") as out:
        for i, (_, fname) in enumerate(shards):
            with open(os.path.join(dir_path, fname), "rb") as f:
                header = f.readline()
                if i == 0:
                    out.write(header)
                shutil.copyfileobj(f, out)
    return out_path


def _native_savetxt_e18(path: str, matrix: np.ndarray, chunks: int = 0) -> bool:
    """Native ``np.savetxt(fmt='%.18e', delimiter=',')``; False when the
    native tier is switched off."""
    lib = native.get_lib()
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    if lib is None or m.ndim != 2:
        return False
    rc = lib.hipsc_write_matrix_e18(path.encode(), m.ctypes.data, m.shape[0], m.shape[1],
                                    int(chunks))
    if rc != 0:
        raise OSError(f"native matrix writer failed on {path} (rc {rc})")
    return True


def _savetxt_csv(path: str, matrix: np.ndarray) -> None:
    if not _native_savetxt_e18(path, matrix):
        np.savetxt(path, matrix, delimiter=",")


def append_data_csv(path: str, current_step: int, number_agents: int, step_time: float,
                    memory_mb: float, method_times: Dict[str, float]) -> None:
    """Running performance CSV, one row per output step; the header is
    written when the file is created."""
    new_file = not os.path.exists(path)
    with open(path, "a", newline="") as file:
        writer = csv.writer(file)
        if new_file:
            writer.writerow(["Step Number", "Number Cells", "Step Time", "Memory (MB)"]
                            + list(method_times.keys()))
        writer.writerow([current_step, number_agents, step_time, memory_mb]
                        + list(method_times.values()))


def process_memory_mb() -> float:
    """RSS of the current process in MB, read from /proc."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE") / 1024**2
    except (OSError, ValueError, IndexError):
        return 0.0


def write_tda_csvs(tda_path: str, name: str, current_step: int, locations: np.ndarray,
                   gata6: np.ndarray, nanog: np.ndarray) -> None:
    """Topological-data-analysis location splits: red = GATA6 > NANOG,
    green = the rest, all."""
    red = gata6 > nanog
    groups = {"red": locations[red, 0:2], "green": locations[~red, 0:2],
              "all": locations[:, 0:2]}
    for key, locs in groups.items():
        path = os.path.join(tda_path, key)
        check_direct(path)
        _savetxt_csv(os.path.join(path, f"{name}_tda_{key}_{current_step}.csv"), locs)


def write_gradient_csvs(gradients_path: str, name: str, current_step: int,
                        gradients: Dict[str, np.ndarray]) -> None:
    """One 2D CSV per morphogen lattice."""
    for gradient_name, grid in gradients.items():
        path = os.path.join(gradients_path, gradient_name)
        check_direct(path)
        grid = np.asarray(grid)
        if grid.ndim == 3:
            grid = grid[:, :, 0]
        _savetxt_csv(os.path.join(path, f"{name}_{gradient_name}_{current_step}.csv"), grid)


# ---------------------------------------------------------------------------
# image rendering
# ---------------------------------------------------------------------------


def _stamp_circles(image, xs, ys, rads, colors):
    """Vectorized circle rasterizer, one scatter per radius class: each agent
    stamps a disk template (black 1 px outline ring and colored fill) into
    the flat image. NumPy applies scattered writes in order, so agent-major
    order makes later agents overdraw earlier ones."""
    h, w, _ = image.shape
    # one sentinel row absorbs out-of-bounds template pixels
    flat = np.empty((h * w + 1, 3), np.uint8)
    flat[:-1] = image.reshape(-1, 3)
    for rad in np.unique(rads):
        sel = rads == rad
        x = xs[sel].astype(np.int32)
        y = ys[sel].astype(np.int32)
        col = colors[sel]
        r_out = int(rad) + 1
        span = np.arange(-r_out, r_out + 1, dtype=np.int32)
        dyy, dxx = np.meshgrid(span, span, indexing="ij")
        d2 = dxx * dxx + dyy * dyy
        keep = d2 <= r_out * r_out
        dy, dx = dyy[keep], dxx[keep]  # (T,) template offsets
        is_fill = (d2[keep] <= int(rad) * int(rad))[None, :, None]  # (1, T, 1)
        py = y[:, None] + dy[None, :]  # (n, T)
        px = x[:, None] + dx[None, :]
        ok = (py >= 0) & (py < h) & (px >= 0) & (px < w)
        idx = np.where(ok, py * np.int32(w) + px, np.int32(h * w))
        vals = np.where(is_fill, col[:, None, :], np.uint8(0))  # (n, T, 3)
        flat[idx.ravel()] = vals.reshape(-1, 3)
    image[:] = flat[:-1].reshape(h, w, 3)
    return image


def render_step_image(locations: np.ndarray, radii: np.ndarray, colors: np.ndarray,
                      size: Tuple[float, float, float], image_quality: int,
                      background: Tuple[int, int, int] = (0, 0, 0),
                      origin_bottom: bool = True) -> np.ndarray:
    """The simulation space as a BGR image ``image_quality`` pixels wide:
    a filled circle with a black outline per cell, flipped vertically for a
    bottom-left origin."""
    x_size = image_quality
    scale = x_size / size[0]
    y_size = math.ceil(scale * size[1])
    image = np.zeros((y_size, x_size, 3), dtype=np.uint8)
    image[:, :] = background
    xs = (scale * locations[:, 0]).astype(int)
    ys = (scale * locations[:, 1]).astype(int)
    rads = (scale * radii).astype(int)
    image = _stamp_circles(image, xs, ys, rads, colors)
    if origin_bottom:
        image = image[::-1]
    return np.ascontiguousarray(image)


def hipsc_cell_colors(states: np.ndarray, gata6: np.ndarray, nanog: np.ndarray, field: int,
                      color_mode: bool) -> np.ndarray:
    """BGR cell colors of both reference color modes."""
    n = states.shape[0]
    colors = np.empty((n, 3), dtype=np.uint8)
    colors[:] = (32, 252, 22)  # green
    if color_mode:
        colors[(gata6 >= nanog) & (gata6 != 0)] = (255, 255, 255)
    else:
        colors[(gata6 == nanog) & (gata6 == 0)] = (255, 50, 50)  # blue
        colors[(gata6 == nanog) & (gata6 == field - 1)] = (30, 255, 255)  # yellow
        colors[gata6 > nanog] = (255, 255, 255)  # white
    colors[states == 1] = (0, 0, 230)  # red overrides everything
    return colors


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 4) -> bytes:
    """PNG bytes of a BGR uint8 image (8-bit RGB, no filter, zlib at
    ``level``)."""
    h, w, _ = image.shape
    rows = np.empty((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 0] = 0  # filter type None on every row
    rows[:, 1:] = image[:, :, ::-1].reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def save_image_png(path: str, image: np.ndarray, compression: int = 4) -> None:
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(path, image, [cv2.IMWRITE_PNG_COMPRESSION, compression])
        return
    with open(path, "wb") as f:
        f.write(encode_png(image, compression))


# ---------------------------------------------------------------------------
# async output pipeline
# ---------------------------------------------------------------------------
#
# The device step needs no host data, so outputs run on one background worker
# against snapshot arrays while the next step executes. One worker keeps
# frames in order; callers flush before reading frames back (video assembly)
# and at loop exit.

_IO_POOL = None
_IO_PENDING: List = []


def submit_output(fn, *args, **kwargs):
    """Run an output task on the background writer thread. A task that has
    already failed is raised at the next submit, so a broken output path
    stops the run early."""
    global _IO_POOL
    if _IO_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _IO_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="hipsc-io")
    for prev in _IO_PENDING:
        if prev.done() and prev.exception() is not None:
            flush_outputs()  # drains the queue and raises with full context
    fut = _IO_POOL.submit(fn, *args, **kwargs)
    _IO_PENDING.append(fut)
    return fut


def flush_outputs() -> None:
    """Block until every submitted output task has finished; re-raise the
    first worker exception and print any further ones."""
    global _IO_PENDING
    pending, _IO_PENDING = _IO_PENDING, []
    errors = []
    for fut in pending:
        try:
            fut.result()
        except BaseException as exc:  # noqa: BLE001 — aggregated below
            errors.append(exc)
    if errors:
        for extra in errors[1:]:
            print(f"output worker error (suppressed behind first): {extra!r}")
        raise errors[0]


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------


def natural_step_sort(file_list: List[str]) -> List[str]:
    """Sort frame files by their trailing step number."""
    return sorted(file_list, key=lambda x: int(re.split(r"(\d+)", x)[-2]))


def create_video_from_images(images_path: str, out_path: str, video_quality: int, fps: float,
                             progress=None) -> Optional[str]:
    """Compile the step PNGs into an mp4 scaled to ``video_quality`` pixels
    wide, frames in step order. Returns the path written, or None when there
    are no frames or no encoder is installed (then one line says so)."""
    if not os.path.isdir(images_path):
        return None
    file_list = [f for f in os.listdir(images_path) if f.endswith(".png")]
    if not file_list:
        return None
    file_list = natural_step_sort(file_list)
    encoder = video_encoder()
    if encoder is None:
        print(f"no video encoder is installed (cv2 or imageio): {out_path} not written")
        return None

    if encoder == "cv2":
        cv2 = _cv2()
        first = cv2.imread(os.path.join(images_path, file_list[0]))
        size = first.shape[0:2]
        scale = video_quality / size[1]
        new_size = (video_quality, int(scale * size[0]))
        video = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, new_size)
        for i, fname in enumerate(file_list):
            image = cv2.imread(os.path.join(images_path, fname))
            if image.shape[0:2] != (new_size[1], new_size[0]):
                image = cv2.resize(image, new_size, interpolation=cv2.INTER_AREA)
            video.write(image)
            if progress is not None:
                progress(i, len(file_list))
        video.release()
    else:
        import imageio.v2 as imageio

        with imageio.get_writer(out_path, fps=fps) as writer:
            for i, fname in enumerate(file_list):
                writer.append_data(imageio.imread(os.path.join(images_path, fname)))
                if progress is not None:
                    progress(i, len(file_list))
    return out_path
