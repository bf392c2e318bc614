"""The port's txn rerun harness as module fixtures, for the twins of the
reference's meta suites: tests/conftest.py sets JUICEFS_TXN_RERUN=1 and
arms only the reference's harness, so a twin module imports these two
fixtures to run every port txn closure twice, as the reference's suites
run theirs. The port's modules are imported at collection (the two
harnesses both patch time.time during a doubled run)."""

from __future__ import annotations

import pytest

from juicefs_tpu_torch.utils import txnwatch


@pytest.fixture(scope="module", autouse=True)
def port_txnwatch():
    """Arm the port's rerun harness for the importing module."""
    assert txnwatch.enabled()
    txnwatch.install()
    try:
        yield txnwatch
    finally:
        txnwatch.uninstall()


@pytest.fixture(autouse=True)
def port_txnwatch_guard(port_txnwatch):
    """Fail a test during which a port txn closure diverged on its rerun."""
    before = len(txnwatch.violations())
    yield
    new = txnwatch.violations()[before:]
    assert not new, "port txn rerun violations:\n" + "\n".join(
        f"[{v['engine']}] {v['closure']}: {v['detail']}" for v in new)
