"""PyTorch port: the kernel build (``kernels.build``) driven through a
stand-in compiler, since the real ``nvcc`` exists only beside the card: one
compile per source, all started before any is waited on, then one link; a
failed compile raises and leaves no library."""

import stat
import sys

import pytest

from hipsc_abm_tpu_torch import kernels

# logs "<compile|link> <start|end> <time>"; a compile takes 1 s, and one of
# a source that holds the word "broken" fails
FAKE_NVCC = r'''#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
kind = "compile" if "-c" in args else "link"
def log(what):
    with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
        f.write(f"{{kind}} {{what}} {{time.time()!r}}\n")
log("start")
if kind == "compile":
    if "broken" in open(args[-1]).read():
        print(args[-1] + ": error: broken")
        sys.exit(2)
    time.sleep(1.0)
with open(out, "w") as f:
    f.write("ok")
print("ptxas info    : Used 32 registers")
log("end")
'''


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    exe = tmp_path / "nvcc"
    exe.write_text(FAKE_NVCC.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(kernels, "nvcc", lambda: str(exe))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (src / name).write_text(f"// {name}\n")
    (src / "shared.cuh").write_text("// header\n")
    monkeypatch.setattr(kernels, "SRC_DIR", src)
    return src, log


def _calls(log):
    return [line.split() for line in log.read_text().splitlines()]


def test_build_compiles_every_source_at_once_then_links(fake_nvcc):
    _, log = fake_nvcc
    lib = kernels.build()
    assert lib == kernels.library_path() and lib.read_text() == "ok"
    calls = _calls(log)
    assert sorted(k for k, what, _ in calls if what == "start") == ["compile"] * 3 + ["link"]
    # every compile started before any of them ended; the link came last
    starts = [float(t) for k, what, t in calls if (k, what) == ("compile", "start")]
    ends = [float(t) for k, what, t in calls if (k, what) == ("compile", "end")]
    assert max(starts) < min(ends)
    assert [k for k, _, _ in calls[-2:]] == ["link", "link"]
    report = lib.with_suffix(".log").read_text()
    assert all(f"== {n}" in report for n in ("a.cu", "b.cu", "c.cu", "link"))
    assert "registers" in report
    # the objects are gone, and a second build reuses the library
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])
    assert kernels.build() == lib and len(_calls(log)) == len(calls)


def test_failed_compile_raises_and_leaves_no_library(fake_nvcc):
    src, log = fake_nvcc
    (src / "b.cu").write_text("broken\n")
    with pytest.raises(RuntimeError, match="b.cu"):
        kernels.build()
    assert not kernels.library_path().exists()
    kinds = {k for k, _, _ in _calls(log)}
    assert kinds == {"compile"}  # no link after a failed compile
    assert [p.name for p in kernels.BUILD_DIR.iterdir()] == [
        kernels.library_path().with_suffix(".log").name]
