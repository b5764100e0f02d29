"""The port's public surface against the JAX package's: an ``ast`` walk of
both trees' modules (no import of either).

Every module of the JAX package has a counterpart at the same path in the
port (``ops/pallas_kernels.py``'s is ``ops/kernels.py`` with
``csrc/``), except ``shuffle/ici.py``, the mesh half of the shuffle
(ROADMAP, A.9). Every public top-level name of a JAX module (a function,
a class, a module-level assignment; names starting with ``_`` are
private) is defined, assigned or imported at the top level of its
counterpart, or listed below with the reason it is not: ``LEFT_OUT``
(names that exist only for JAX, XLA or Pallas, or that the port does
otherwise on purpose) and ``PENDING_A9`` (the mesh names). A JAX conf
constant whose key the port lists in ``config/conf.IGNORED_KEYS`` needs
no counterpart either.
"""

import ast
import os

import pytest

from spark_rapids_tpu_torch.config.conf import IGNORED_KEYS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "spark_rapids_tpu")
PORT = os.path.join(ROOT, "spark_rapids_tpu_torch")

# JAX module -> the port's module holding its counterpart
MOVED = {"ops/pallas_kernels.py": "ops/kernels.py"}
# JAX modules with no counterpart yet
NO_MODULE = {"shuffle/ici.py": "the ICI mesh transport (ROADMAP, A.9)"}

_XLA_CACHE = ("the JAX package's jit kernel cache and its build hooks; "
              "the port's kernels are hand CUDA built once by nvcc "
              "(ops/cudalib, obs/compilecache)")
_LEDGER = ("the compile ledger of XLA compiles (ROADMAP, left out on "
           "purpose): the port's one compile is the nvcc build, which "
           "obs/compilecache records")
LEFT_OUT = {
    "__init__.py:enable_persistent_cache_if_accelerated":
        "JAX's persistent compilation cache",
    "nativelib.py:get_lib": "the JAX package's make-built libtpunative; "
                            "the port's host arena is numpy and torch",
    "nativelib.py:native_available": "the same native library",
    "exec/outofcore.py:hash_split_kernel":
        "a jitted hash split; the port splits with torch ops in "
        "exec/outofcore",
    "exec/stagecompiler/cutter.py:FUSION_DONATE_KEY":
        "XLA buffer donation has no counterpart in eager PyTorch",
    "exec/transitions.py:scan_dict_numerics":
        "its key, scan.dictEncodeNumerics, is in IGNORED_KEYS",
    "exec/transitions.py:scan_raw_parts":
        "its key, scan.deviceDecode, is in IGNORED_KEYS: every Parquet "
        "scan takes the raw-page route",
    "sql/parquet_raw.py:file_mtime":
        "the port keys its caches on file_stamp (mtime ns, size, inode) "
        "on purpose (ROADMAP)",
    "ops/floatbits.py:f64_bits_arith":
        "float64 bit patterns by arithmetic, for TPUs without 64-bit "
        "bitcasts; torch views the bits",
    "ops/floatbits.py:np_f64_bits": "the numpy twin of f64_bits_arith",
    "ops/sortops.py:MAX_DIRECT_SORT_OPERANDS":
        "an XLA sort's compile-time operand cap; the port's lexsort "
        "chains stable sorts at any width",
    "ops/densered.py:limb_bits_for":
        "limb widths that keep the TPU's f32/bfloat16 one-hot matmul "
        "exact; the port reduces with index_add_",
    "ops/aggregate.py:GROUP_SLOTS":
        "the TPU's scatter width of the fast aggregation branch; the "
        "port's branches size their slot tables themselves",
    "columnar/column.py:DICT_SMALL_TABLE_ROWS":
        "the JAX package seeds a small in-memory table's dictionaries "
        "from the whole column; the port's uploads encode per scan by "
        "host_dict_encode's probe",
    "columnar/column.py:DICT_MAX_CARD_SMALL": "the same seeding",
    "columnar/column.py:string_host_buffers_have_nul":
        "the JAX package's string host-buffer layout; the port checks "
        "the values (string_values_have_nul)",
    "obs/compilecache.py:install":
        "installs JAX's persistent compilation cache; the port's "
        "compile cache is the nvcc build directory",
    "shims/loader.py:ModernJaxProvider": "a jax release range",
    "shims/loader.py:LegacyJaxProvider": "a jax release range",
}
for _n in ("cached_jit", "clear", "clear_build_hook", "expr_signature",
           "kernel_profile", "kernel_profile_reset", "schema_signature",
           "set_build_hook"):
    LEFT_OUT[f"utils/kernelcache.py:{_n}"] = _XLA_CACHE
for _n in ("CompileLedger", "DEFAULT_MAX_ENTRIES", "DUMP_TAIL", "LEDGER",
           "analyze", "aval_signature", "current_dispatch",
           "dispatch_begin", "dispatch_end", "kernel_key", "parse_aval",
           "recording_suppressed"):
    LEFT_OUT[f"obs/compileledger.py:{_n}"] = _LEDGER

PENDING_A9 = {f"parallel/distributed.py:{n}" for n in (
    "data_parallel_mesh", "distributed_hash_aggregate_step",
    "dryrun_distributed_q1", "dryrun_multichip_full", "dryrun_session_mesh",
    "exchange_stats_log", "mesh_broadcast", "mesh_collect_shards",
    "mesh_exchange_hash", "mesh_exchange_parts", "mesh_range_bounds")}
PENDING_A9.add("shuffle/manager.py:mesh_map_output_statistics")


def _modules(root):
    out = []
    for d, _dirs, files in os.walk(root):
        if os.path.basename(d) in ("__pycache__", "build", "csrc"):
            continue
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), root))
    return sorted(out)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read())


def _defined(tree, with_imports: bool):
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.add(node.target.id)
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _ignored_conf_constants():
    """JAX conf constants whose key the port accepts and ignores."""
    out = set()
    for node in _tree(os.path.join(JAX, "config", "conf.py")).body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "register"
                and node.value.args[0].value in IGNORED_KEYS):
            out.add(node.targets[0].id)
    return out


def test_every_jax_module_has_a_counterpart():
    missing = [m for m in _modules(JAX) if m not in NO_MODULE
               and not os.path.exists(os.path.join(PORT, MOVED.get(m, m)))]
    assert missing == []
    for m in NO_MODULE:
        assert os.path.exists(os.path.join(JAX, m))
        assert not os.path.exists(os.path.join(PORT, m))


@pytest.mark.parametrize("module", [m for m in _modules(JAX)
                                    if m not in NO_MODULE])
def test_public_names_have_counterparts(module):
    want = _defined(_tree(os.path.join(JAX, module)), with_imports=False)
    if module in MOVED:
        return  # the kernels: ops/kernels.py and csrc/ (PERF.md §6)
    have = _defined(_tree(os.path.join(PORT, module)), with_imports=True)
    excused = {n for n in want if f"{module}:{n}" in LEFT_OUT
               or f"{module}:{n}" in PENDING_A9}
    if module == "config/conf.py":
        excused |= _ignored_conf_constants()
    missing = sorted(want - have - excused)
    assert missing == [], f"{module}: {missing}"
    # nothing listed that the port has after all
    stale = sorted(n for n in excused & have
                   if f"{module}:{n}" in LEFT_OUT)
    assert stale == [], f"{module}: listed as left out but present {stale}"


def test_tables_name_only_jax_names():
    for entry in list(LEFT_OUT) + sorted(PENDING_A9):
        module, name = entry.split(":")
        assert name in _defined(_tree(os.path.join(JAX, module)),
                                with_imports=False), entry
