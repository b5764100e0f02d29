"""Scan pushdown (counterpart of the JAX package's ``sql/pushdown.py``):
predicate -> row-group, stripe and partition pruning; projection ->
column pruning.

The statistics half runs on the host against the footers' statistics
(the reference's ParquetFilters, GpuParquetScan.scala:204-246, and its
ORC search arguments):

  * ``extract_pushable_filters`` splits a filter condition into conjuncts
    and keeps the shapes statistics can answer: ``col <op> literal``,
    ``IsNull``/``IsNotNull(col)``, ``col IN (literals)``;
  * ``maybe_matches`` is the conservative test a split's (min, max,
    null_count) statistics give: True means "may hold matching rows" (the
    filter above the scan still runs; pruning only drops splits that
    provably match nothing);
  * ``partition_value_matches`` is the exact test of a hive directory's
    partition value.

A date or timestamp literal is held in its physical form (days or
microseconds since the epoch, ``exprs/core._canonicalize_literal``) while
a footer gives ``datetime`` statistics. The pushed value is then a
``TemporalLiteral``: the same number (the JAX package's tuple compares
equal) that knows its unit, which ``_coerce_pair`` turns into a ``date``
or ``datetime`` (a date against a timestamp widens to midnight, Spark's
coercion), so a date filter prunes. The JAX package's ``_coerce_pair``
compares the number with the statistic, which raises, so its date and
timestamp filters never prune.

The column-pruning half:

  * ``prune_filter_columns`` puts a narrowing Project above every Filter
    whose output carries columns no ancestor references, so the filter's
    row compaction feeds fewer columns onward, and at each join input, so
    a join expands only the columns read above it and its keys or
    condition (a semi or anti join's build side down to its keys; a cross
    join's sides down to what is read above it).
  * ``annotate_scan_pruning`` marks each scan with the columns the query
    references (join keys included), and the planner scans only those.

  * a logical subtree shared by several branches (Q2's min-cost
    subquery, Q11's threshold, Q17's average) is pruned once, by the
    union of every requirement reaching it, and every parent gets the
    same rewritten object, so the planner makes structurally identical
    physical subtrees that ``exec/reuse.py`` runs once (the JAX package's
    shared-subtree coordination).
"""

from __future__ import annotations

import copy
import datetime
from typing import Any, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.sql import plan as lp
from spark_rapids_tpu_torch.sql.exprs.core import Col, Expression, Literal
from spark_rapids_tpu_torch.sql.exprs.predicates import (
    And, Eq, Ge, Gt, In, IsNotNull, IsNull, Le, Lt, Neq,
)

# (column_name, op, value); op in < <= > >= == != isnull isnotnull in
PushedFilter = Tuple[str, str, Any]

_CMP_OPS = {Lt: "<", Le: "<=", Gt: ">", Ge: ">=", Eq: "==", Neq: "!="}
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==",
         "!=": "!="}
_EPOCH = datetime.datetime(1970, 1, 1)


class TemporalLiteral(int):
    """A date or timestamp literal's physical value (days or microseconds
    since the epoch) that knows its ``unit``; ``as_python`` is its
    ``datetime.date`` or ``datetime.datetime``."""

    def __new__(cls, value: int, unit: str):
        out = super().__new__(cls, int(value))
        out.unit = unit
        return out

    def __repr__(self) -> str:
        return int.__repr__(self)

    def as_python(self):
        if self.unit == "days":
            return _EPOCH.date() + datetime.timedelta(days=int(self))
        return _EPOCH + datetime.timedelta(microseconds=int(self))


def _literal_value(e: Expression):
    if not isinstance(e, Literal) or e.value is None:
        return None
    name = e.dtype(None).name
    if name == "date32":
        return TemporalLiteral(e.value, "days")
    if name == "timestamp_us":
        return TemporalLiteral(e.value, "us")
    return e.value


def extract_pushable_filters(cond: Expression) -> List[PushedFilter]:
    """Conjuncts of ``cond`` a footer-statistics test can answer. Anything
    else is ignored (the filter in the plan still applies it)."""
    out: List[PushedFilter] = []

    def visit(e: Expression) -> None:
        if isinstance(e, And):
            visit(e.children[0])
            visit(e.children[1])
            return
        if isinstance(e, IsNull) and isinstance(e.children[0], Col):
            out.append((e.children[0].name, "isnull", None))
            return
        if isinstance(e, IsNotNull) and isinstance(e.children[0], Col):
            out.append((e.children[0].name, "isnotnull", None))
            return
        if isinstance(e, In) and isinstance(e.children[0], Col):
            # a NULL in the list never equals anything, so pruning on the
            # non-null values is safe
            vals = tuple(v for v in e.values if v is not None)
            if vals:
                out.append((e.children[0].name, "in", vals))
            return
        for cls, op in _CMP_OPS.items():
            if isinstance(e, cls):
                left, right = e.children
                if isinstance(left, Col) and _literal_value(right) is not None:
                    out.append((left.name, op, _literal_value(right)))
                elif (isinstance(right, Col)
                      and _literal_value(left) is not None):
                    out.append((right.name, _FLIP[op], _literal_value(left)))
                return

    visit(cond)
    return out


def _widen(v):
    """A ``date`` as the ``datetime`` of its midnight; else as it is."""
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return datetime.datetime.combine(v, datetime.time())
    return v


def _coerce_pair(a, b):
    """Best-effort comparable pair; raises on incomparable types (the
    caller treats that as "cannot prune")."""
    import pandas as pd
    if isinstance(b, TemporalLiteral):
        b = b.as_python()
        if isinstance(a, datetime.datetime) or isinstance(
                b, datetime.datetime):
            a, b = _widen(a), _widen(b)
    if isinstance(a, (np.datetime64, pd.Timestamp)) or isinstance(
            b, (np.datetime64, pd.Timestamp)):
        return pd.Timestamp(a), pd.Timestamp(b)
    # binary-physical statistics arrive as bytes; str(b'x') would give
    # "b'x'" and mis-compare (wrong pruning). Strict decode only: an
    # undecodable value raises and the caller keeps the split.
    if isinstance(a, bytes):
        a = a.decode("utf-8", "strict")
    if isinstance(b, bytes):
        b = b.decode("utf-8", "strict")
    if isinstance(a, str) or isinstance(b, str):
        return str(a), str(b)
    return a, b


def maybe_matches(mn, mx, null_count, num_values, op: str, value) -> bool:
    """Conservative test: can a split with these column statistics hold a
    row satisfying (col op value)? Unknown statistics -> True."""
    try:
        if op == "isnull":
            return null_count is None or null_count > 0
        if op == "isnotnull":
            return num_values is None or num_values > 0 or mn is not None
        if mn is None or mx is None:
            return True
        if op == "in":
            return any(maybe_matches(mn, mx, null_count, num_values,
                                     "==", v) for v in value)
        lo, v = _coerce_pair(mn, value)
        hi, _ = _coerce_pair(mx, value)
        if op == "<":
            return lo < v
        if op == "<=":
            return lo <= v
        if op == ">":
            return hi > v
        if op == ">=":
            return hi >= v
        if op == "==":
            return lo <= v <= hi
        if op == "!=":
            return not (lo == hi == v)
    except Exception:
        return True
    return True


def partition_value_matches(pval, op: str, value) -> bool:
    """Exact test of a hive partition value (partition pruning, the layer
    Spark itself does for the reference)."""
    try:
        if op == "isnull":
            return pval is None
        if op == "isnotnull":
            return pval is not None
        if pval is None:
            return False
        if op == "in":
            return any(partition_value_matches(pval, "==", v)
                       for v in value)
        a, b = _coerce_pair(pval, value)
        return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
                "==": a == b, "!=": a != b}[op]
    except Exception:
        return True


def _cols_of(*exprs) -> set:
    out: set = set()
    stack = list(exprs)
    while stack:
        e = stack.pop()
        if isinstance(e, Col):
            out.add(e.name)
        stack.extend(e.children)
    return out


def _narrow(node, required):
    """``node`` under a name-selection Project when its output has columns
    outside ``required``."""
    names = node.schema().names
    keep = [n for n in names if n in required]
    if keep and len(keep) < len(names):
        return lp.LogicalProject(node, [(n, Col(n)) for n in keep])
    return node


def _with_children(node, kids):
    # never mutate: logical nodes are shared by live DataFrames
    new = copy.copy(node)
    new.children = kids
    return new


def prune_filter_columns(root):
    """Top-down column pruning at Filters (and Project outputs no ancestor
    reads). Returns the rewritten root.

    A node referenced from several parents is pruned with the UNION of
    every requirement reaching it (requirement propagation is
    union-distributive node by node, so the union is exact) and every
    parent receives the SAME rewritten object: pruning each occurrence on
    its own would make the branches structurally different and defeat
    the physical subtree reuse (``exec/reuse.py``). A first pass collects
    the requirements at the shared nodes, nested ones included; the
    second rewrites."""
    refs: dict = {}

    def count_refs(n) -> None:
        refs[id(n)] = refs.get(id(n), 0) + 1
        if refs[id(n)] == 1:
            for c in n.children:
                count_refs(c)
    count_refs(root)
    shared_ids = {i for i, c in refs.items() if c > 1}
    state = {"collecting": bool(shared_ids)}
    collected: dict = {}     # id(shared node) -> [required per occurrence]
    shared_memo: dict = {}   # id(shared node) -> its one rewritten subtree
    collect_memo: set = set()

    def rewrite(node, required):
        # ``required``: the names the parent needs; None = all
        if id(node) in shared_ids:
            if state["collecting"]:
                collected.setdefault(id(node), []).append(
                    None if required is None else set(required))
                # descend so nested shared nodes collect too, each
                # (node, requirement) pair once: without the memo nested
                # shared nodes walk 2^depth times
                mkey = (id(node), None if required is None
                        else frozenset(required))
                if mkey in collect_memo:
                    return node
                collect_memo.add(mkey)
            else:
                got = shared_memo.get(id(node))
                if got is None:
                    reqs = collected.get(id(node), [None])
                    union = (None if any(r is None for r in reqs)
                             else set().union(*reqs))
                    sid = id(node)
                    shared_ids.discard(sid)  # rewrite the body plainly
                    got = rewrite(node, union)
                    if union is not None and node.children:
                        # a shared scan stays bare, so a filter above each
                        # occurrence still reaches it (pushed filters);
                        # annotate_scan_pruning prunes its columns
                        got = _narrow(got, union)
                    shared_ids.add(sid)
                    shared_memo[sid] = got
                return got
        if isinstance(node, lp.LogicalFilter):
            child_req = (None if required is None else
                         (required | _cols_of(node.condition))
                         & set(node.schema().names))
            f = lp.LogicalFilter(rewrite(node.children[0], child_req),
                                 node.condition)
            return f if required is None else _narrow(f, required)
        if isinstance(node, lp.LogicalProject):
            exprs = node.exprs
            if required is not None:
                kept = [(n, e) for n, e in node.exprs if n in required]
                if not kept:
                    # nothing referenced (count(*) above): keep one output,
                    # a bare column where there is one, for the row count
                    bare = [(n, e) for n, e in node.exprs
                            if isinstance(e, Col)]
                    kept = bare[:1] or node.exprs[:1]
                exprs = kept
            return lp.LogicalProject(
                rewrite(node.children[0], _cols_of(*(e for _n, e in exprs))),
                exprs)
        if isinstance(node, lp.LogicalAggregate):
            req = _cols_of(*(e for _n, e in node.grouping),
                           *(e for _n, e in node.results))
            return lp.LogicalAggregate(rewrite(node.children[0], req),
                                       node.grouping, node.results)
        if isinstance(node, lp.LogicalJoin):
            lnames = set(node.children[0].schema().names)
            rnames = set(node.children[1].schema().names)
            # a condition join keeps the condition's columns on each side
            conds = [node.condition] if node.condition is not None else []
            keyreq_l = _cols_of(*node.left_keys, *conds)
            keyreq_r = _cols_of(*node.right_keys, *conds)
            if required is None:
                lreq = rreq = None
            else:
                lreq = (required | keyreq_l) & lnames
                rreq = (required | keyreq_r) & rnames
            if node.join_type in ("leftsemi", "leftanti"):
                # the build side gives no output column: its keys suffice
                rreq = keyreq_r & rnames
            left = rewrite(node.children[0], lreq)
            right = rewrite(node.children[1], rreq)
            if lreq is not None:
                left = _narrow(left, lreq)
            if rreq is not None:
                right = _narrow(right, rreq)
            return lp.LogicalJoin(left, right, node.join_type,
                                  node.left_keys, node.right_keys,
                                  node.condition)
        if isinstance(node, lp.LogicalSort):
            req = (None if required is None else
                   (required | _cols_of(*(o.expr for o in node.orders)))
                   & set(node.schema().names))
            return lp.LogicalSort(rewrite(node.children[0], req),
                                  node.orders, node.is_global)
        if isinstance(node, lp.LogicalWindow):
            cnames = set(node.children[0].schema().names)
            req = (None if required is None else
                   (required | _cols_of(*node.expressions())) & cnames)
            child = rewrite(node.children[0], req)
            if req is not None:
                child = _narrow(child, req)
            return _with_children(node, [child])
        if isinstance(node, (lp.LogicalLimit, lp.LogicalRepartition,
                             lp.LogicalCoalesce)):
            return _with_children(
                node, [rewrite(c, required) for c in node.children])
        if isinstance(node, lp.LogicalUnion):
            if required is None:
                return _with_children(
                    node, [rewrite(c, None) for c in node.children])
            if not required:
                # count(*)-style: keep each branch's first column, so the
                # branches stay aligned by position
                kids = []
                for c in node.children:
                    first = {c.schema().names[0]}
                    kids.append(_narrow(rewrite(c, first), first))
                return _with_children(node, kids)
            return _with_children(node, [_narrow(rewrite(c, required),
                                                 required)
                                         for c in node.children])
        # Expand, Generate, Scan, Range: children keep their full output
        return _with_children(node, [rewrite(c, None)
                                     for c in node.children])

    if state["collecting"]:
        rewrite(root, None)   # pass A: the requirements at shared nodes
        state["collecting"] = False
    return rewrite(root, None)


def required_scan_columns(root) -> Optional[set]:
    """Every column name any expression of the tree references, or None
    when a subtree forwards a scan's whole schema to the output (a bare
    collect): then nothing may be pruned."""
    names: set = set()
    narrowing = (lp.LogicalProject, lp.LogicalAggregate)

    def exprs_of(node):
        out = []
        for attr in ("exprs", "grouping", "results"):
            out.extend(e for _n, e in getattr(node, attr, ()) or ())
        if getattr(node, "condition", None) is not None:
            out.append(node.condition)
        out.extend(getattr(node, "left_keys", ()) or ())
        out.extend(getattr(node, "right_keys", ()) or ())
        out.extend(o.expr for o in getattr(node, "orders", ()) or ())
        for proj in getattr(node, "projections", ()) or ():
            out.extend(e for _n, e in proj)
        if isinstance(node, lp.LogicalWindow):
            out.extend(node.expressions())
        if isinstance(node, lp.LogicalGenerate):
            out.append(node.source)
        return out

    def forwards_scan(node) -> bool:
        """Does ``node``'s output carry a scan's full schema unprojected?"""
        if isinstance(node, lp.LogicalScan):
            return True
        if isinstance(node, narrowing):
            return False
        return any(forwards_scan(c) for c in node.children)

    if forwards_scan(root):
        return None
    for node in root.walk():
        names |= _cols_of(*exprs_of(node))
    return names


def annotate_scan_pruning(root) -> None:
    """Mark each scan with the column subset the query references
    (``_pruned_columns``, read by the planner), or None."""
    cols = required_scan_columns(root)
    for node in root.walk():
        if not isinstance(node, lp.LogicalScan):
            continue
        node._pruned_columns = None
        if cols is None or not hasattr(node.source, "with_columns"):
            continue
        keep = [c for c in node.source.schema.names if c in cols]
        if keep and len(keep) < len(node.source.schema.names):
            node._pruned_columns = keep
