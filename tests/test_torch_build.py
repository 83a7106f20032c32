"""The kernel builder (rcot_torch/kernels/build.py), on the CPU, with a
stand-in nvcc: a shell script under CUDA_HOME/bin that writes the object or
the library its `-o` names, or fails for a source whose name it is told.

build() compiles every csrc/*.cu with its own nvcc process, links the
objects into a library whose name hashes the sources, the headers and the
flags, and keeps the compiler's output in build.log, one section a source
with its exit code and its compile time; a failed source raises with its
name and leaves no library.
"""

import os
import stat

import pytest

from rcot_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; -c) src="$2"; shift;; esac
  shift
done
case "$src" in *"$RCOT_FAKE_NVCC_FAIL"*) [ -n "$RCOT_FAKE_NVCC_FAIL" ] && { echo "error in $src"; exit 1; };; esac
echo "ptxas info : compiled $src"
: > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.delenv("RCOT_FAKE_NVCC_FAIL", raising=False)
    return tmp_path / "kernels"


def test_build_compiles_every_source_and_logs_each_ones_time(fake_nvcc):
    lib = build.build(fake_nvcc)
    assert lib.exists() and lib.parent == fake_nvcc
    assert lib.name == f"librcot_kernels_{build._digest(build.sources())}.so"
    log = (fake_nvcc / "build.log").read_text()
    for src in build.sources():
        section = log.split(f"== {src.name} (rc 0, ")[1]
        seconds = float(section.split(" s)")[0])
        assert seconds >= 0 and f"compiled {src}" in section
    assert "== link (rc 0)" in log
    # an unchanged tree is not built again
    mtime = os.stat(lib).st_mtime_ns
    assert build.build(fake_nvcc) == lib and os.stat(lib).st_mtime_ns == mtime


def test_a_failed_source_raises_by_name_and_leaves_no_library(fake_nvcc, monkeypatch):
    monkeypatch.setenv("RCOT_FAKE_NVCC_FAIL", "mdta.cu")
    with pytest.raises(RuntimeError, match=r"kernel build failed \(mdta\.cu\)"):
        build.build(fake_nvcc)
    assert not list(fake_nvcc.glob("*.so"))
    assert "== mdta.cu (rc 1, " in (fake_nvcc / "build.log").read_text()
