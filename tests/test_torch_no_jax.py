"""The port stands alone: a fresh interpreter in which ``import jax`` and
``import hevc_tpu`` both fail imports every module of hevc_tpu_torch,
encodes a small IPP/WPP stream with the port's encoder and decodes it
through the port's CLI on the CPU, with every SEI MD5 correct."""
import os
import subprocess
import sys

import pytest

from hevc_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, os, sys
sys.modules["jax"] = None          # any "import jax" raises ImportError
sys.modules["hevc_tpu"] = None     # and so does any "import hevc_tpu"
import hevc_tpu_torch
root = os.path.dirname(hevc_tpu_torch.__file__)
mods = []
for d, subdirs, files in os.walk(root):
    subdirs[:] = [s for s in subdirs if s not in ("build", "csrc",
                                                  "__pycache__")]
    for f in sorted(files):
        if f.endswith(".py"):
            rel = os.path.relpath(os.path.join(d, f), os.path.dirname(root))
            name = rel[:-3].replace(os.sep, ".")
            mods.append(name[:-len(".__init__")]
                        if name.endswith(".__init__") else name)
for m in mods:
    importlib.import_module(m)
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
cfg = EncoderConfig(width=64, height=64, qp=30, gop="ipp", wpp=True,
                    deblocking=True, sao=True, log2_ctb_size=5,
                    search_range=2, seed=1)
enc = IntraEncoder(cfg)
path = sys.argv[1]
with open(path, "wb") as f:
    for t in range(3):
        f.write(enc.encode_frame(synth_frame("gradient", 64, 64, t, seed=9)))
from hevc_tpu_torch import cli
rc = cli.main(["-i", path, "-v", "40", "--device", "cpu"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "hevc_tpu")
                and sys.modules[m] is not None)
print("MODULES", len(mods), "BLOCKED", loaded, "RC", rc)
"""


@pytest.mark.skipif(not native.available(),
                    reason="native toolchain unavailable")
def test_port_decodes_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT,
                        str(tmp_path / "s.265")], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("Correct MD5") == 3, r.stdout
    assert "frame= 3 " in r.stdout
    last = r.stdout.strip().splitlines()[-1].split()
    # the sub-packages' modules too (bitstream, cabac, coding, decoder,
    # encoder, io, native, ops)
    assert last[0] == "MODULES" and int(last[1]) >= 50, last
    assert r.stdout.strip().endswith("BLOCKED [] RC 0")


def test_cuda_device_needs_a_card():
    import torch
    from hevc_tpu_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
