"""TPCxBB Q21, Q22, Q23, Q24, Q25, Q26 and Q28 through the port's session
against the JAX package's session and pandas, on the CPU (the helpers and
the conventions are ``test_torch_tpcxbb_a.py``'s)."""

import pytest

from tests.test_torch_tpcxbb_a import check_query
from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401


@pytest.mark.parametrize("qname", ["q21", "q22", "q23", "q24", "q25",
                                   "q26", "q28"])
def test_tpcxbb_query_matches_reference_session(qname):
    check_query(qname)
