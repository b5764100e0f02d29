"""Replayable specs of kernel-wrapper arguments (the pre-warm's substrate;
counterpart of the JAX package's ``utils/argspec.py``).

The JAX package captures a jitted kernel's argument tree at its compile
so that a later process compiles the same program again. The port
compiles nothing per shape; what a first launch pays on the card is the
nvcc build or load of its library, CUDA's lazy load of the module and the
caching allocator's first segments of those sizes. The spec keeps what
that depends on:

  * ``capture(args, kwargs)`` walks a wrapper call's arguments into a
    JSON-able spec: each tensor's shape, dtype and device; a
    ``DeviceBatch``'s schema and each column's form (its data, validity,
    dictionary codes, char slab and lengths, plain offsets and chars,
    each a tensor spec) with its static dictionary tuple; static scalars
    and strings as they are; lists, tuples and string-keyed dicts
    recursively. Anything else (an object the walk cannot rebuild, a
    dictionary past ``_MAX_DICT_CHARS``) makes the whole spec None: the
    call is not replayable, and the pre-warm counts it skipped;
  * ``build(spec, device=None)`` makes the zero-filled tree back on the
    device (``device`` overrides the recorded one): every validity
    false, every row count 0, dictionary codes at the NULL sentinel (the
    dictionary's size), data zero. Each wrapper takes that as a valid
    empty launch: no row is live, so none is read past a zero length or
    written through a made-up offset.

The spec keeps no row data, only shapes and the static values a launch's
layout depends on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# serialized dictionary budget of one spec
_MAX_DICT_CHARS = 4096
# the tensors of a column, by attribute
_COLUMN_TENSORS = ("data", "validity", "dict_codes", "slab64", "lens",
                   "chars", "offsets")


class _NotReplayable(Exception):
    pass


def _tensor_spec(t) -> Dict[str, Any]:
    return {"t": "arr", "dtype": str(t.dtype).replace("torch.", ""),
            "shape": [int(s) for s in t.shape], "device": str(t.device)}


def _dict_values_spec(values: tuple) -> List[Any]:
    total = 0
    out: List[Any] = []
    for v in values:
        if hasattr(v, "item"):  # numpy scalar -> its python value
            v = v.item()
        if v is not None and not isinstance(v, (str, int, float, bool)):
            raise _NotReplayable(f"dictionary value {type(v).__name__}")
        total += len(v) if isinstance(v, str) else 8
        if total > _MAX_DICT_CHARS:
            raise _NotReplayable("dictionary too large")
        out.append(v)
    return out


def _col_spec(col) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"t": "col", "dtype": col.dtype.name}
    for attr in _COLUMN_TENSORS:
        t = getattr(col, attr)
        if t is not None:
            spec[attr] = _tensor_spec(t)
    if col.dict_values is not None:
        spec["dict"] = _dict_values_spec(col.dict_values)
    return spec


def _spec(v) -> Any:
    import torch

    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    if isinstance(v, DeviceBatch):
        return {"t": "batch", "names": list(v.schema.names),
                "cols": [_col_spec(c) for c in v.columns],
                "rows": _tensor_spec(v.num_rows)}
    if isinstance(v, DeviceColumn):
        return _col_spec(v)
    if isinstance(v, torch.Tensor):
        return _tensor_spec(v)
    if v is None or isinstance(v, (bool, str, int, float)):
        return {"t": "s", "v": v}
    if isinstance(v, tuple):
        return {"t": "tup", "items": [_spec(x) for x in v]}
    if isinstance(v, list):
        return {"t": "list", "items": [_spec(x) for x in v]}
    if isinstance(v, dict):
        if not all(isinstance(k, str) for k in v):
            raise _NotReplayable("non-string dict key")
        return {"t": "map", "items": {k: _spec(x) for k, x in v.items()}}
    raise _NotReplayable(type(v).__name__)


def capture(args, kwargs) -> Optional[Dict[str, Any]]:
    """The spec of one call's arguments, or None where they cannot be
    rebuilt. Never raises."""
    try:
        return {"args": [_spec(a) for a in (args or ())],
                "kwargs": {k: _spec(v) for k, v in (kwargs or {}).items()}}
    except _NotReplayable:
        return None
    except Exception:  # noqa: BLE001 — capture is best-effort metadata
        return None


def avals(spec: Optional[Dict[str, Any]]) -> Optional[List[str]]:
    """A flat ``dtype[shape]`` rendering of a spec's tensors (the
    manifest's readable signature), or None."""
    if spec is None:
        return None
    out: List[str] = []

    def rec(node) -> None:
        if isinstance(node, dict):
            if node.get("t") == "arr":
                out.append(f"{node['dtype']}{node['shape']}")
                return
            for k in sorted(node):
                rec(node[k])
        elif isinstance(node, list):
            for x in node:
                rec(x)
    rec(spec)
    return out


# ---------------------------------------------------------------------------
# Reconstruction
# ---------------------------------------------------------------------------

def _zeros(spec: Dict[str, Any], device):
    import torch
    return torch.zeros(tuple(spec["shape"]),
                       dtype=getattr(torch, spec["dtype"]),
                       device=device if device is not None
                       else spec.get("device", "cpu"))


def _build_col(spec: Dict[str, Any], device):
    from spark_rapids_tpu_torch.columnar import dtype as dtypes
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    dt = dtypes.by_name(spec["dtype"])
    parts = {a: _zeros(spec[a], device) for a in _COLUMN_TENSORS
             if a in spec}
    dict_values = tuple(spec["dict"]) if spec.get("dict") is not None \
        else None
    if dict_values is not None and "dict_codes" in parts:
        # the NULL sentinel: in range for every consumer
        parts["dict_codes"].fill_(len(dict_values))
    return DeviceColumn(dt, parts.get("data"), parts["validity"],
                        dict_codes=parts.get("dict_codes"),
                        dict_values=dict_values,
                        slab64=parts.get("slab64"), lens=parts.get("lens"),
                        chars=parts.get("chars"),
                        offsets=parts.get("offsets"))


def _build(spec, device) -> Any:
    t = spec["t"]
    if t == "batch":
        from spark_rapids_tpu_torch.columnar.batch import DeviceBatch, Schema
        cols = [_build_col(c, device) for c in spec["cols"]]
        return DeviceBatch(Schema(spec["names"], [c.dtype for c in cols]),
                           cols, _zeros(spec["rows"], device))
    if t == "col":
        return _build_col(spec, device)
    if t == "arr":
        return _zeros(spec, device)
    if t == "s":
        return spec["v"]
    if t == "tup":
        return tuple(_build(x, device) for x in spec["items"])
    if t == "list":
        return [_build(x, device) for x in spec["items"]]
    if t == "map":
        return {k: _build(x, device) for k, x in spec["items"].items()}
    raise ValueError(f"unknown argspec node: {t}")


def build(spec: Dict[str, Any], device=None) -> Tuple[tuple, dict]:
    """(args, kwargs) rebuilt from a ``capture`` spec: the same tree,
    shapes and dtypes, zero-filled and all-invalid, on ``device`` (None:
    the recorded devices)."""
    return (tuple(_build(s, device) for s in spec.get("args", [])),
            {k: _build(s, device)
             for k, s in spec.get("kwargs", {}).items()})
