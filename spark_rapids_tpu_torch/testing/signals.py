"""SIGUSR1 hand-back for test modules that make port sessions.

A port session installs the SIGUSR1 diagnostics handler
(``obs/monitor.install_signal_diagnostics``) and keeps it until
``stop()``. Most test modules never stop their sessions, and the JAX
package's install never replaces a foreign handler, so a port test that
ran earlier in the same process would keep the JAX package's SIGUSR1
tests from installing theirs. A test module imports the fixture below:

    from spark_rapids_tpu_torch.testing.signals import release_sigusr1  # noqa: F401

and SIGUSR1 goes back to what it was at the module's start when the
module ends (module scope: the tests of one file run on one worker).
"""

from __future__ import annotations

import pytest


@pytest.fixture(scope="module", autouse=True)
def release_sigusr1():
    """At the module's end, remove the port's SIGUSR1 handler if it is
    still in place, and put back the handler the install replaced."""
    yield
    from spark_rapids_tpu_torch.obs.monitor import (
        uninstall_signal_diagnostics,
    )
    uninstall_signal_diagnostics()
