"""The four Mortgage queries through the port's ``TpuSparkSession`` against
the JAX package's session and the pandas references of
``testing/mortgagecases.py``, on the CPU.

Each query (``models/mortgage.QUERIES``) runs at the JAX package's default
confs with ``spark.rapids.sql.exec.CartesianProductExec`` set, as the JAX
package's ``bench.py`` runs them, in test mode (no operator may stay on the
CPU) through the port's session (``device="cpu"``: the device operators'
torch code and the kernels' plain versions) and through its CPU operators
(``spark.rapids.sql.enabled=false``), on the seeded tables of
``models/mortgage_data.py`` at SF 0.03 (60 loans, 720 performance rows),
the size of the JAX package's own Mortgage tests. Keys, counts, dates and
strings exact, float64 at rtol 1e-9; a value rounded to 4 places may take
either neighbour where the reference's unrounded value is a tie.

The JAX package's own full-ETL test is marked slow; here the ETL is held
against the JAX session once, at SF 0.02 (40 loans, 480 performance rows),
and against pandas at SF 0.03.
"""

import numpy as np
import pytest

from spark_rapids_tpu.models import mortgage as ref_mortgage
from spark_rapids_tpu.models import mortgage_data as ref_data
from spark_rapids_tpu_torch.models import mortgage
from spark_rapids_tpu_torch.models import mortgage_data as D
from spark_rapids_tpu_torch.session import TpuSparkSession
from spark_rapids_tpu_torch.testing import mortgagecases
from tests.querytest import with_tpu_session
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

SF = 0.03
ETL_REF_SF = 0.02

_TABLES: dict = {}


def tables(sf: float):
    if sf not in _TABLES:
        _TABLES[sf] = (D.gen_performance(sf), D.gen_acquisition(sf))
    return _TABLES[sf]


def _port(name, sf, **conf):
    b = TpuSparkSession.builder().device("cpu")
    for k, v in {**mortgage.ETL_CONFS, **conf}.items():
        b.config(k, v)
    s = b.get_or_create()
    perf, acq = tables(sf)
    return mortgage.run_query(name, s, s.create_dataframe(perf, 3),
                              s.create_dataframe(acq, 2)).collect()


def _reference_session(name, sf):
    perf, acq = tables(sf)
    fn = getattr(ref_mortgage, "run_etl" if name == "etl" else name)

    def run(rs):
        p, a = rs.create_dataframe(perf, 3), rs.create_dataframe(acq, 2)
        return fn(rs, p) if name == "aggregates_with_percentiles" \
            else fn(rs, p, a)
    return with_tpu_session(run, conf=dict(mortgage.ETL_CONFS))


def test_tables_match_reference_generators():
    """The port's generators give the JAX package's tables."""
    for sf in (ETL_REF_SF, SF):
        perf, acq = tables(sf)
        assert perf.equals(ref_data.gen_performance(sf))
        assert acq.equals(ref_data.gen_acquisition(sf))


@pytest.mark.parametrize("name", list(mortgage.QUERIES))
def test_mortgage_query_matches_pandas(name):
    perf, acq = tables(SF)
    want = mortgagecases.pandas_reference(name, perf, acq)
    assert len(want) > 0
    for conf in ({"spark.rapids.sql.test.enabled": True},
                 {"spark.rapids.sql.enabled": False}):
        got = _port(name, SF, **conf)
        mortgagecases.same_answer(name, got, want)


@pytest.mark.parametrize("name", ["simple_aggregates", "aggregates_with_join",
                                  "aggregates_with_percentiles", "etl"])
def test_mortgage_query_matches_reference_session(session, name):
    sf = ETL_REF_SF if name == "etl" else SF
    want = _reference_session(name, sf)
    got = _port(name, sf, **{"spark.rapids.sql.test.enabled": True})
    mortgagecases.same_answer(name, got, want)
    if name == "etl":
        perf, _ = tables(sf)
        assert len(got) == len(perf)
        assert "Wells Fargo" in set(got.seller_name)
        assert "WELLS FARGO BANK, N.A." not in set(got.seller_name)


def test_percentiles_match_pandas_quantiles():
    """The window formulation's percentiles are pandas' linear quantiles
    of each hash group (the JAX test's check), to one rounding unit."""
    perf, _ = tables(SF)
    got = _port("aggregates_with_percentiles", SF,
                **{"spark.rapids.sql.test.enabled": True})
    h = mortgagecases.loan_hash(perf["loan_id"].to_numpy())
    grouped = perf.assign(h=h).groupby("h")["interest_rate"]
    got = got.set_index("loan_id_hash").sort_index()
    for col, q in mortgagecases.PERCENTILES:
        np.testing.assert_allclose(
            got[col].to_numpy(dtype=float),
            grouped.quantile(q).sort_index().to_numpy(), atol=1.0001e-4,
            err_msg=col)


def test_oversized_concat_sizes_by_live_rows(monkeypatch):
    """A concat whose padded capacity would pass CONCAT_SHRINK_ROWS (the
    ETL's final merge of its 12x cross join's partials) reads its live
    rows once, a counted sync, and sizes its output to them; below the
    threshold it stays sync-free at the summed capacities."""
    import torch
    from spark_rapids_tpu_torch.columnar.batch import DeviceBatch
    from spark_rapids_tpu_torch.exec import tpu
    from spark_rapids_tpu_torch.obs.syncledger import SYNCS
    perf, _ = tables(SF)
    parts = []
    for lo in range(0, 600, 200):
        b = DeviceBatch.from_pandas(perf.iloc[lo:lo + 200][[
            "loan_id", "interest_rate", "quarter"]], device="cpu")
        # 150 live rows of a 256 capacity, the count on the device only,
        # as an aggregate's partial holds it
        b.num_rows, b.host_rows = b.num_rows - 50, None
        parts.append(b)
    schema = parts[0].schema
    before = SYNCS.total()
    out = tpu.concat_device(parts, schema, 2.0, "cpu")
    assert out.capacity == 1024 and SYNCS.total() == before
    monkeypatch.setattr(tpu, "CONCAT_SHRINK_ROWS", 512)
    tpu.reset_concat_shrinks()
    out = tpu.concat_device(parts, schema, 2.0, "cpu")
    assert out.capacity == 512 and int(out.num_rows) == 450
    assert SYNCS.total() == before + 1
    assert tpu.CONCAT_SHRINKS["synced"] == 1
    want = perf.iloc[[i for lo in range(0, 600, 200)
                      for i in range(lo, lo + 150)]].reset_index(drop=True)
    got = out.to_pandas()
    assert torch.equal(torch.tensor(got.loan_id.to_numpy()),
                       torch.tensor(want.loan_id.to_numpy()))
    assert list(got.quarter) == list(want.quarter)
