"""The nvcc build under threads and processes, and its compile cache
(``ops/cudalib.py``, ``obs/compilecache.py``), on the CPU.

This machine has no nvcc: the test points ``cudalib._nvcc`` at a stub
compiler that this test writes (a Python script that records each of its
runs in a file, waits a little and writes its ``-o`` output) and
``ctypes.CDLL`` at a stand-in, so the build's locking is what runs:

  * 8 threads and 2 processes loading one library start exactly one
    compile and all get the same library path;
  * a process that finds the library built counts a persistent hit, the
    build seconds it saved and, where another process built it, a steal;
    an nvcc run counts a backend compile, its seconds and a manifest
    record, and emits ``compileCacheMiss`` and ``backendCompile``;
  * ``SharedCompileCache.configure(dir)`` moves the build directory and
    ``configure("")`` puts the package's own back.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from spark_rapids_tpu_torch.obs.compilecache import SHARED, locked_append
from spark_rapids_tpu_torch.obs.events import EVENTS
from spark_rapids_tpu_torch.obs.metrics import REGISTRY
from spark_rapids_tpu_torch.ops import cudalib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = "compact"

_STUB = '''#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["SRT_STUB_COUNT"], "a") as f:
    f.write(f"{{os.getpid()}}\\n")
time.sleep(0.5)
with open(out, "wb") as f:
    f.write(b"not a real library")
'''

# the same patching in a child process: the stub, the stand-in loader,
# a start line shared with the parent's threads
_CHILD = '''
import os, sys, time
sys.path.insert(0, {repo!r})
from spark_rapids_tpu_torch.ops import cudalib
from spark_rapids_tpu_torch.obs.compilecache import SHARED
cudalib._nvcc = lambda: {stub!r}
class Fake:
    def __init__(self, path):
        self.path = path
    def __getattr__(self, name):
        return type("F", (), {{}})()
cudalib.ctypes.CDLL = Fake
SHARED.configure({build!r})
while not os.path.exists({go!r}):
    time.sleep(0.005)
print(cudalib.load({lib!r}).path)
'''


class _FakeLib:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        return type("F", (), {})()


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """A build directory of the test's own, the stub compiler and the
    stand-in loader; cudalib's state put back afterwards."""
    stub = tmp_path / "nvcc-stub"
    stub.write_text(_STUB.format(python=sys.executable))
    stub.chmod(0o755)
    count = tmp_path / "compiles.txt"
    count.write_text("")
    monkeypatch.setenv("SRT_STUB_COUNT", str(count))
    monkeypatch.setattr(cudalib, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(cudalib.ctypes, "CDLL", _FakeLib)
    build = tmp_path / "build"
    saved_lib = cudalib._LIBS.pop(LIB, None)
    cudalib._RESOLVED.discard(LIB)
    SHARED.configure(str(build))
    yield {"stub": str(stub), "count": count, "build": str(build)}
    SHARED.configure("")
    cudalib._LIBS.pop(LIB, None)
    cudalib._RESOLVED.discard(LIB)
    if saved_lib is not None:
        cudalib._LIBS[LIB] = saved_lib


def _compiles(count) -> list:
    return [ln for ln in count.read_text().splitlines() if ln]


def test_threads_and_processes_start_one_compile(stub_build, tmp_path):
    go = str(tmp_path / "go")
    children = [subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(
            repo=_REPO, stub=stub_build["stub"], build=stub_build["build"],
            go=go, lib=LIB)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ)) for _ in range(2)]
    start = threading.Event()
    got, errs = [], []

    def load():
        start.wait()
        try:
            got.append(cudalib.load(LIB))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)
    threads = [threading.Thread(target=load) for _ in range(8)]
    for th in threads:
        th.start()
    open(go, "w").close()
    start.set()
    for th in threads:
        th.join(60)
    outs = [c.communicate(timeout=120) for c in children]
    assert not errs, errs
    assert all(c.returncode == 0 for c in children), [o[1] for o in outs]
    assert len(_compiles(stub_build["count"])) == 1
    assert len({id(lib) for lib in got}) == 1 and len(got) == 8
    paths = {got[0].path} | {o[0].strip() for o in outs}
    assert paths == {str(cudalib.library_path(LIB))}
    assert str(cudalib.library_path(LIB)).startswith(stub_build["build"])
    # no temporary output left behind
    assert [f for f in os.listdir(stub_build["build"])
            if f.endswith(".tmp")] == []


def test_counters_events_and_steals(stub_build):
    def value(name):
        return REGISTRY.value(name)
    before = {n: value(n) for n in (
        "compileCache.backendCompiles", "compileCache.persistentHits",
        "compileCache.persistentMisses", "sharedCache.steals",
        "sharedCache.hits", "sharedCache.writes")}
    saved_before = REGISTRY.timer("compileCache.timeSaved").count
    EVENTS.reset_for_tests()
    cudalib.load(LIB)
    assert value("compileCache.backendCompiles") == \
        before["compileCache.backendCompiles"] + 1
    assert value("compileCache.persistentMisses") == \
        before["compileCache.persistentMisses"] + 1
    assert value("sharedCache.writes") == before["sharedCache.writes"] + 1
    kinds = [e["kind"] for e in EVENTS.flight_events()]
    assert "compileCacheMiss" in kinds and "backendCompile" in kinds
    assert [r["kernel"] for r in SHARED.manifest_entries().values()] == [
        LIB]
    # a fresh process state: the library is found, its build seconds
    # saved; built by this process, so a hit, not a steal
    cudalib._LIBS.pop(LIB)
    cudalib._RESOLVED.discard(LIB)
    cudalib.load(LIB)
    assert value("compileCache.persistentHits") == \
        before["compileCache.persistentHits"] + 1
    assert value("sharedCache.hits") == before["sharedCache.hits"] + 1
    assert REGISTRY.timer("compileCache.timeSaved").count == \
        saved_before + 1
    # the sidecar names another builder: a steal
    side = str(cudalib.library_path(LIB)) + ".json"
    rec = json.load(open(side))
    rec["pid"] = -1
    json.dump(rec, open(side, "w"))
    cudalib._LIBS.pop(LIB)
    cudalib._RESOLVED.discard(LIB)
    cudalib.load(LIB)
    assert value("sharedCache.steals") == before["sharedCache.steals"] + 1
    assert len(_compiles(stub_build["count"])) == 1
    st = SHARED.stats()
    assert st["enabled"] and st["knownKernels"] == 1


def test_configure_moves_the_build_directory(tmp_path):
    default = cudalib.build_dir()
    assert SHARED.configure(str(tmp_path / "shared"))
    try:
        assert cudalib.build_dir() == tmp_path / "shared"
        assert cudalib.library_path(LIB).parent == tmp_path / "shared"
    finally:
        SHARED.configure("")
    assert cudalib.build_dir() == default == cudalib.BUILD


def test_locked_append_lands_whole_lines(tmp_path):
    path = str(tmp_path / "m.jsonl")

    def writer(i):
        for j in range(50):
            assert locked_append(path, (json.dumps(
                {"w": i, "j": j, "pad": "x" * 500}) + "\n").encode())
    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    lines = open(path).read().splitlines()
    assert len(lines) == 200
    assert all(json.loads(ln)["pad"] == "x" * 500 for ln in lines)
