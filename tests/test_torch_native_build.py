"""Both native stage-A libraries are built once, by the root
``conftest.py``, before any test worker starts: inside a worker each is up
to date with its sources and loads, and ``_build`` compiles nothing."""
import importlib
import os
import shutil
import subprocess

import pytest


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
@pytest.mark.parametrize("package", ["hevc_tpu", "hevc_tpu_torch"])
def test_stage_a_library_is_built_before_the_workers(package, monkeypatch):
    native = importlib.import_module(package + ".native")
    sources = (native._SRC,) + native._HDRS
    assert os.path.exists(native._SO)
    assert os.path.getmtime(native._SO) >= max(map(os.path.getmtime,
                                                   sources))
    assert native.available()

    def compile_(*a, **k):
        raise AssertionError(f"_build compiled: {a}")

    monkeypatch.setattr(subprocess, "run", compile_)
    assert native._build() == native._SO
