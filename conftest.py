"""Builds both native stage-A libraries once, before any test runs.

``hevc_tpu.native`` and ``hevc_tpu_torch.native`` compile their C++ stage A
with g++ on first use.  Under several test workers each worker would start
the same build at once, and one that loses ``hevc_tpu.native``'s shared
temporary file reads ``available()`` False and skips whole files without a
failure.  So the controlling process (pytest alone, or xdist's controller
before its workers exist) runs one child process that asks ``available()``
of both; the workers then find the libraries up to date.  The child keeps
JAX and both packages out of this process.  The session header says which
library is ready; a build that fails prints the compiler's error, and the
tests that need the library skip as they do on a machine without g++.
"""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

_BUILD = r"""
import importlib, subprocess, sys
from concurrent.futures import ThreadPoolExecutor

def build(name):
    native = importlib.import_module(name + ".native")
    if native.available():
        return f"{name}.native: {native._SO} ready"
    try:
        native._build()
    except subprocess.CalledProcessError as e:
        print(f"{name}.native: g++ failed:\n{e.stderr.decode()}",
              file=sys.stderr)
    return f"{name}.native: not available, its tests skip"

with ThreadPoolExecutor(2) as pool:
    print("\n".join(pool.map(build, ("hevc_tpu", "hevc_tpu_torch"))))
"""

_HEADER = []


def pytest_configure(config):
    if hasattr(config, "workerinput"):      # an xdist worker
        return
    r = subprocess.run([sys.executable, "-c", _BUILD], cwd=ROOT,
                       stdout=subprocess.PIPE, text=True)
    _HEADER[:] = r.stdout.splitlines()
    if r.returncode:
        _HEADER.append(f"stage-A build: the child exited {r.returncode}")


def pytest_report_header(config):
    return _HEADER
