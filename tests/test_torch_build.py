"""The port's kernel build (``flowstate_tpu_torch.kernels.build``) without a
card: a stand-in ``nvcc`` (a shell script that sleeps, records its call and
makes an empty shared library with the host's C compiler) takes the place
of the CUDA compiler, so the CPU can check what the build does around it:
one compiler per source, all running at once, one library per source
keyed by its contents and the headers', reuse of what is built, and a
failure reported with the compiler's output.
"""

import os
import shutil
import stat
import time

import pytest

from flowstate_tpu_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
out=""; prev=""; for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"; prev="$a"; src="$a"; done
echo "start $(basename "$src")" >> "$LOG"
sleep 1
case "$src" in *broken*) echo "error: broken source"; exit 2;; esac
echo 'int x;' | cc -shared -fPIC -x c -o "$out" -
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    if shutil.which("cc") is None:
        pytest.fail("the host's C compiler `cc` is needed for this test")
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("alpha", "beta", "gamma"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("LOG", str(log))
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LOADED", None)
    return csrc, log


def test_one_compiler_per_source_in_parallel_and_reuse(fake_cuda):
    csrc, log = fake_cuda
    t0 = time.perf_counter()
    res = build.build()
    wall = time.perf_counter() - t0
    assert sorted(res.libs) == ["alpha", "beta", "gamma"]
    assert sorted(log.read_text().split()) == sorted(
        ["start", "alpha.cu", "start", "beta.cu", "start", "gamma.cu"])
    assert wall < 2.5, wall           # three 1 s compilers, run at once
    assert len({os.path.dirname(p) for p in res.paths.values()}) == 3
    assert build.build() is res       # loaded once per process

    # a new process: nothing to build; an edited source builds alone
    build._LOADED = None
    assert build.build().seconds == 0.0
    (csrc / "beta.cu").write_text("// beta, edited\n")
    build._LOADED = None
    again = build.build()
    assert log.read_text().split().count("beta.cu") == 2
    assert log.read_text().split().count("alpha.cu") == 1
    assert again.paths["beta"] != res.paths["beta"]
    assert again.paths["alpha"] == res.paths["alpha"]


def test_a_failing_source_raises_with_the_compiler_output(fake_cuda):
    csrc, _ = fake_cuda
    (csrc / "broken.cu").write_text("// does not compile\n")
    with pytest.raises(RuntimeError, match="error: broken source"):
        build.build()
    assert build._LOADED is None
    built = [f for _, _, files in os.walk(build.BUILD_DIR) for f in files
             if f.endswith(".so")]
    assert sorted(built) == ["libalpha.so", "libbeta.so", "libgamma.so"]


def test_an_edited_header_builds_every_source_anew(fake_cuda):
    csrc, log = fake_cuda
    (csrc / "shared.cuh").write_text("// shared\n")
    first = build.build()
    assert sorted(first.libs) == ["alpha", "beta", "gamma"]   # not a source
    (csrc / "shared.cuh").write_text("// shared, edited\n")
    build._LOADED = None
    again = build.build()
    assert all(again.paths[k] != first.paths[k] for k in first.paths)
    assert log.read_text().split().count("alpha.cu") == 2
