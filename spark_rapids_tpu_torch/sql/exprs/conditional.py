"""Conditional expressions (counterpart of the JAX package's
``sql/exprs/conditional.py``, its ``if`` and ``CASE WHEN``): numeric,
boolean and date results. A branch whose value is a string needs the
JAX package's row-select string kernel (``select_strings``) over the
packed-chars layout, which the port has not (ROADMAP A.5), so such an
expression is tagged off the device with that reason; the host evaluates
it. Coalesce and NaNvl wait for ROADMAP A.6.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from spark_rapids_tpu_torch.columnar import dtypes
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.columnar.dtype import (
    DType, common_type, torch_dtype,
)
from spark_rapids_tpu_torch.sql.exprs.core import (
    DevCol, DevValue, EvalContext, Expression,
)
from spark_rapids_tpu_torch.sql.exprs.hostutil import (
    host_unary_values, rebuild_series,
)

_STRING_BRANCH = ("a string-valued branch needs the row-select string "
                  "kernel over the packed-chars layout, not ported yet "
                  "(ROADMAP A.5)")


def _result_type(schema: Schema, exprs: List[Expression]) -> DType:
    out = exprs[0].dtype(schema)
    for e in exprs[1:]:
        t = e.dtype(schema)
        if t != out:
            out = common_type(out, t)
    return out


def _as_pair(ctx: EvalContext, v: DevValue, dt: DType):
    """(data, validity) at the batch's capacity, cast to ``dt``."""
    from spark_rapids_tpu_torch.sql.exprs.cast import cast_data
    c = ctx.broadcast(v)
    data = c.data
    if c.dtype != dt:
        data, _ = cast_data(data, c.dtype, dt)
    return data, c.validity


def _host_values(s: pd.Series):
    """(values, validity, dtype) of a host column."""
    from spark_rapids_tpu_torch.columnar.batch import _pandas_col_dtype
    values, validity, _ = host_unary_values(s)
    return values, validity, _pandas_col_dtype(s)


def _host_cast(values: np.ndarray, src: DType, dt: DType) -> np.ndarray:
    if src == dt:
        return values
    from spark_rapids_tpu_torch.sql.exprs.cast import cast_data
    out, _ = cast_data(torch.from_numpy(np.ascontiguousarray(values)), src,
                       dt)
    return out.numpy()


class If(Expression):
    """if(predicate, then, else); a NULL predicate takes the else branch."""

    def __init__(self, pred: Expression, then: Expression,
                 other: Expression):
        super().__init__([pred, then, other])

    def dtype(self, schema: Schema) -> DType:
        return _result_type(schema, self.children[1:])

    def __repr__(self) -> str:
        p, t, f = self.children
        return f"if({p!r}, {t!r}, {f!r})"

    def device_supported(self, schema: Schema) -> Optional[str]:
        if self.dtype(schema).is_string:
            return _STRING_BRANCH
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        pv = ctx.broadcast(self.children[0].eval_device(ctx))
        tv = self.children[1].eval_device(ctx)
        fv = self.children[2].eval_device(ctx)
        dt = tv.dtype if tv.dtype == fv.dtype else common_type(tv.dtype,
                                                               fv.dtype)
        tdata, tval = _as_pair(ctx, tv, dt)
        fdata, fval = _as_pair(ctx, fv, dt)
        cond = pv.data & pv.validity
        return DevCol(dt, torch.where(cond, tdata, fdata),
                      torch.where(cond, tval, fval))

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        p, pval, index = host_unary_values(self.children[0].eval_host(df))
        t, tval, tt = _host_values(self.children[1].eval_host(df))
        f, fval, ft = _host_values(self.children[2].eval_host(df))
        cond = p.astype(np.bool_) & pval
        if tt.is_string or ft.is_string:
            dt = dtypes.STRING
            data = np.where(cond, t, f)
        else:
            dt = tt if tt == ft else common_type(tt, ft)
            data = np.where(cond, _host_cast(t, tt, dt),
                            _host_cast(f, ft, dt))
        return rebuild_series(data, np.where(cond, tval, fval), dt, index)


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... [ELSE ve] END: the first branch whose
    predicate is TRUE (a NULL predicate is not), else ``ve`` or NULL."""

    def __init__(self, branches: List[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        flat: List[Expression] = []
        for p, v in branches:
            flat += [p, v]
        if else_value is not None:
            flat.append(else_value)
        super().__init__(flat)
        self.n_branches = len(branches)
        self.has_else = else_value is not None

    def _branches(self):
        return [(self.children[2 * i], self.children[2 * i + 1])
                for i in range(self.n_branches)]

    def _else(self) -> Optional[Expression]:
        return self.children[-1] if self.has_else else None

    def _values(self) -> List[Expression]:
        values = [v for _, v in self._branches()]
        return values + ([self._else()] if self.has_else else [])

    def dtype(self, schema: Schema) -> DType:
        return _result_type(schema, self._values())

    def __repr__(self) -> str:
        parts = ["CASE"]
        for p, v in self._branches():
            parts.append(f"WHEN {p!r} THEN {v!r}")
        if self.has_else:
            parts.append(f"ELSE {self._else()!r}")
        return " ".join(parts + ["END"])

    def device_supported(self, schema: Schema) -> Optional[str]:
        if any(v.dtype(schema).is_string for v in self._values()):
            return _STRING_BRANCH
        return None

    def eval_device(self, ctx: EvalContext) -> DevValue:
        evaluated = [(ctx.broadcast(p.eval_device(ctx)), v.eval_device(ctx))
                     for p, v in self._branches()]
        ev = self._else().eval_device(ctx) if self.has_else else None
        dt = evaluated[0][1].dtype
        for t in [v.dtype for _, v in evaluated[1:]] + (
                [ev.dtype] if ev is not None else []):
            if t != dt:
                dt = common_type(dt, t)
        if ev is not None:
            data, validity = _as_pair(ctx, ev, dt)
        else:
            data = torch.full((ctx.capacity,), dtypes.null_fill_value(dt),
                              dtype=torch_dtype(dt.np_dtype),
                              device=ctx.device)
            validity = torch.zeros((ctx.capacity,), dtype=torch.bool,
                                   device=ctx.device)
        taken = torch.zeros((ctx.capacity,), dtype=torch.bool,
                            device=ctx.device)
        for p, v in evaluated:
            hit = p.data & p.validity
            cond = hit & ~taken
            vdata, vval = _as_pair(ctx, v, dt)
            data = torch.where(cond, vdata, data)
            validity = torch.where(cond, vval, validity)
            taken = taken | hit
        return DevCol(dt, data, validity)

    def eval_host(self, df: pd.DataFrame) -> pd.Series:
        evaluated, types = [], []
        for p, v in self._branches():
            pv, pval, _ = host_unary_values(p.eval_host(df))
            vv, vval, vt = _host_values(v.eval_host(df))
            evaluated.append((pv.astype(np.bool_) & pval, vv, vval))
            types.append(vt)
        if self.has_else:
            ev, e_val, et = _host_values(self._else().eval_host(df))
            types.append(et)
        dt = types[0]
        for t in types[1:]:
            if t != dt:
                dt = dtypes.STRING if dt.is_string or t.is_string \
                    else common_type(dt, t)
        n = len(df)
        if self.has_else:
            data = ev if dt.is_string else _host_cast(ev, types[-1], dt)
            validity = e_val
        else:
            data = (np.full(n, None, dtype=object) if dt.is_string else
                    np.full(n, dtypes.null_fill_value(dt),
                            dtype=dt.np_dtype))
            validity = np.zeros(n, dtype=np.bool_)
        taken = np.zeros(n, dtype=np.bool_)
        for (cond, vv, vval), t in zip(evaluated, types):
            use = cond & ~taken
            vv2 = vv if dt.is_string else _host_cast(vv, t, dt)
            data = np.where(use, vv2, data)
            validity = np.where(use, vval, validity)
            taken = taken | cond
        return rebuild_series(data, validity, dt, df.index)
