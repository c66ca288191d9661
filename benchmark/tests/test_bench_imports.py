"""No module the harness loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``hevc_tpu`` (names compared whole: the program's own,
``hevc_tpu_torch``, begins with ``hevc_tpu``), and the reference loads
nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

from benchmark import bank, run

FORBIDDEN = {"jax", "jaxlib", "flax", "hevc_tpu"}
# the modules that may import the program: the system under test's adapter
# and the bank's encoder front end (never run by a run)
PROGRAM_SIDE = {"program.py", "make_bank.py"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for p in glob.glob(os.path.join(bank.HERE, "**", "*.py"),
                       recursive=True):
        if os.sep + "tests" + os.sep not in p:
            yield p


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not set(_imports(p)) & FORBIDDEN, p


def test_only_the_adapter_imports_the_program():
    for p in _sources():
        names = set(_imports(p))
        if os.path.basename(p) not in PROGRAM_SIDE:
            assert "hevc_tpu_torch" not in names, p
        if os.sep + "reference" + os.sep in p:
            assert not names & {"torch", "hevc_tpu_torch"}, p


BLOCK = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _run(code, blocked):
    env = dict(os.environ, PYTHONPATH=bank.ROOT)
    return subprocess.run([sys.executable, "-c",
                           BLOCK.format(blocked=blocked) + code],
                          cwd=bank.ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_none_of_them(tiny_cell, tmp_path):
    """A run of the tiny cell on the CPU, with the JAX names blocked from
    import, ends with none of them in ``sys.modules``."""
    import pickle
    p = tmp_path / "cell.pkl"
    p.write_bytes(pickle.dumps(tiny_cell))
    r = _run(f"""
import pickle
from benchmark import bank, run
bank.BUILD = {str(tmp_path / 'build')!r}
cell = pickle.load(open({str(p)!r}, "rb"))
res = run.run_cell(cell, 3, 1.0, False, device="cpu")
assert res["correct"], res
print("LOADED", run.forbidden_modules())
""", sorted(FORBIDDEN))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout


def test_the_reference_loads_nothing_of_the_program(tiny_cell):
    aus = list(tiny_cell.segments[0].aus)
    r = _run(f"""
import pickle, sys
from benchmark.refcache import segment_digests
d = segment_digests(pickle.loads({__import__('pickle').dumps(aus)!r}), 0)
assert len(d) == {len(aus)}
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}} &
                       {{"hevc_tpu_torch", "torch", "jax", "hevc_tpu"}}))
""", ["hevc_tpu_torch", "torch"] + sorted(FORBIDDEN))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hevc_tpu_torchx", sys)
    assert "hevc_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hevc_tpu.api", sys)
    assert "hevc_tpu" in run.forbidden_modules()
