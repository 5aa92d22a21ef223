"""Kernel builds (game_engine_tpu_torch/_build.py): a library is named
by a hash of every source in csrc/, so an edit to any header alone builds a
new library instead of loading a stale one; a failed build raises with the
compiler's output. Builds only g++ host harnesses, in a temporary copy of
csrc/."""

import os
import shutil

import pytest

from game_engine_tpu_torch import _build


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, src)
    monkeypatch.setattr(_build, "_CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return src


@pytest.mark.parametrize("header,src", [
    ("room_step.cuh", "rollout.cu"),
    ("room_step.cuh", "rollout_host.cpp"),
    ("lossgrad.cuh", "lossgrad.cu"),
    ("lossgrad.cuh", "lossgrad_host.cpp"),
    ("lossgrad.cu", "lossgrad_host.cpp"),
    ("lossgrad_host.cpp", "lossgrad.cu"),
    ("lossgrad.cuh", "search.cu"),
    ("room_step.cuh", "search.cu"),
    ("room_step.cuh", "search_host.cpp"),
    ("gamesim.cpp", "gamesim.cpp"),
    ("search.cu", "rollout.cu"),
    ("launch_plan.cuh", "rollout.cu"),
    ("launch_plan.cuh", "search.cu"),
    ("chat_decode.cuh", "chat_decode.cu"),
    ("chat_decode.cuh", "chat_decode_host.cpp"),
    ("chat_decode.cu", "rollout.cu"),
    ("room_step.cuh", "chat_decode.cu"),
    ("chat_decode.cu", "chat_decode_host.cpp"),
    ("chat_decode_host.cpp", "chat_decode.cu"),
])
def test_header_edit_renames_the_library(csrc, header, src):
    cmd = ["nvcc", "-O3"]
    path = str(csrc / src)
    before = _build.lib_path(path, "lib", cmd)
    assert _build.lib_path(path, "lib", cmd) == before
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = _build.lib_path(path, "lib", cmd)
    assert after != before
    assert _build.lib_path(path, "lib", cmd + ["-G"]) != after  # the command counts too


def test_header_edit_rebuilds_the_host_harness(csrc):
    job = (str(csrc / "lossgrad_host.cpp"), "liblossgrad_host", _build._GXX_CMD)
    (first,) = _build._compile_all([job])
    assert os.path.exists(first)
    assert _build._compile_all([job]) == [first]  # unchanged: built once
    with open(csrc / "lossgrad.cuh", "a") as f:
        f.write("\n// edited\n")
    (second,) = _build._compile_all([job])
    assert second != first and os.path.exists(second)


def test_failed_build_raises_with_compiler_output(csrc):
    (csrc / "broken.cpp").write_text("int f() { return not_declared; }\n")
    with pytest.raises(RuntimeError, match="not_declared"):
        _build._compile_all([(str(csrc / "broken.cpp"), "libbroken", _build._GXX_CMD)])
    assert not [n for n in os.listdir(_build.BUILD_DIR) if n.startswith("libbroken")]


def test_threads_asking_at_once_build_the_library_once(csrc, monkeypatch):
    """The server's handler threads can ask for the same library at once
    (the first requests after a start): one compiler runs, every thread
    gets the same path."""
    import subprocess
    import threading

    started = []
    popen = subprocess.Popen

    def counting_popen(cmd, *args, **kwargs):
        started.append(cmd)
        return popen(cmd, *args, **kwargs)

    monkeypatch.setattr(subprocess, "Popen", counting_popen)
    job = (str(csrc / "lossgrad_host.cpp"), "liblossgrad_host", _build._GXX_CMD)
    paths, errors = [], []

    def build():
        try:
            paths.extend(_build._compile_all([job]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(started) == 1 and len(set(paths)) == 1 and len(paths) == 4
    assert os.path.exists(paths[0])


def test_gamesim_and_search_sources_are_in_the_hash(csrc):
    """The native simulator's and the search kernel's sources sit in csrc/,
    so the hash of every library covers them: an edit to either renames
    the simulator's library, and the simulator builds there with g++ -O3."""
    names = set(os.listdir(csrc))
    assert {"gamesim.cpp", "search.cu", "search_host.cpp"} <= names
    sim = str(csrc / "gamesim.cpp")
    before = _build.lib_path(sim, "libgamesim", _build.GAMESIM_CMD)
    for name in ("gamesim.cpp", "search.cu"):
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        after = _build.lib_path(sim, "libgamesim", _build.GAMESIM_CMD)
        assert after != before
        before = after
    (path,) = _build._compile_all([(sim, "libgamesim", _build.GAMESIM_CMD)])
    assert os.path.exists(path) and path.startswith(_build.BUILD_DIR)
