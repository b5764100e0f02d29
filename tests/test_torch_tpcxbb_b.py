"""TPCxBB Q14, Q15, Q16, Q17 and Q20 through the port's session against
the JAX package's session and pandas, on the CPU (the helpers and the
conventions are ``test_torch_tpcxbb_a.py``'s)."""

import pytest

from tests.test_torch_tpcxbb_a import check_query


@pytest.mark.parametrize("qname", ["q14", "q15", "q16", "q17", "q20"])
def test_tpcxbb_query_matches_reference_session(qname):
    check_query(qname)
