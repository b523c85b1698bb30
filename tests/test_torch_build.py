"""The kernel build (``microflow_tpu_torch/kernels/build.py``) from two
threads at once, against a fake ``nvcc`` (there is none on the CPU): one
build, one loaded library, no temporary file left behind."""

import os
import stat
import threading

import pytest

from microflow_tpu_torch.kernels import build

# Stands in for nvcc: counts its calls, waits so that a second caller would
# overlap it, and compiles a library with the entry point's symbol to the
# path after -o.
FAKE_NVCC = """#!/bin/sh
echo call >> "{count}"
sleep 0.5
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
printf 'extern "C" int {symbol}(void) {{ return 0; }}\\n' > "$out.cc"
g++ -shared -fPIC -o "$out" "$out.cc" && rm "$out.cc"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    count = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(count=count, symbol=build.SIGNATURES["qgemm"][0]))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    out = tmp_path / "torch_ext"
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    monkeypatch.setattr(build, "_LIBS", {})
    return count, out


def test_two_threads_build_a_kernel_once(fake_nvcc):
    count, out = fake_nvcc
    barrier = threading.Barrier(2)
    libs, errors = [], []

    def run():
        try:
            barrier.wait(timeout=30)
            libs.append(build.library("qgemm"))
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert count.read_text().splitlines() == ["call"]
    assert len(libs) == 2 and libs[0] is libs[1] and list(build._LIBS) == ["qgemm"]
    so = build._target("qgemm")
    assert os.path.dirname(so) == str(out)
    assert sorted(os.listdir(out)) == sorted([os.path.basename(so), os.path.basename(so) + ".log"])
    assert libs[0]._name == so
    # a later call finds the library loaded: no build
    assert build.library("qgemm") is libs[0]
    assert count.read_text().splitlines() == ["call"]


def test_the_temporary_name_carries_the_process_and_thread(fake_nvcc, monkeypatch):
    """Two processes, or two threads of one, never write one file."""
    names = []
    popen = build.subprocess.Popen

    def record(cmd, **kw):
        names.append(cmd[cmd.index("-o") + 1])
        return popen(cmd, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", record)
    build.build_all(("qgemm",))
    (tmp,) = names
    assert tmp == f"{build._target('qgemm')}.{os.getpid()}.{threading.get_ident()}.tmp"
    assert not os.path.exists(tmp)
