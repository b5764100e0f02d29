"""Column pruning of the logical plan before planning (the pruning half of
the JAX package's ``sql/pushdown.py``; statistics pushdown and row-group
pruning wait for the Parquet scan behind the session, ROADMAP A.2).

  * ``prune_filter_columns`` puts a narrowing Project above every Filter
    whose output carries columns no ancestor references, so the filter's
    row compaction feeds fewer columns onward, and at each join input, so
    a join expands only the columns read above it and its keys or
    condition (a semi or anti join's build side down to its keys; a cross
    join's sides down to what is read above it).
  * ``annotate_scan_pruning`` marks each scan with the columns the query
    references (join keys included), and the planner scans only those.

The JAX package's coordination of logical subtrees shared by several
branches is not ported: the plans of this slice share none.
"""

from __future__ import annotations

import copy
from typing import Optional

from spark_rapids_tpu_torch.sql import plan as lp
from spark_rapids_tpu_torch.sql.exprs.core import Col


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
    reads). Returns the rewritten root."""

    def rewrite(node, required):
        # ``required``: the names the parent needs; None = all
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
        # Expand, Scan, Range: children keep their full output
        return _with_children(node, [rewrite(c, None)
                                     for c in node.children])

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
