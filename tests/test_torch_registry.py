"""The port's algorithm listings (``repro_torch.core.registry.available``,
``repro_torch.ann.functional.available_functional``) against the JAX
package's: both name the same algorithms, and they are the reference's
minus the families not ported yet."""

import pytest

torch = pytest.importorskip("torch")

from repro.ann.functional import \
    available_functional as jx_available_functional  # noqa: E402
from repro.core.registry import available as jx_available  # noqa: E402
from repro_torch.ann.functional import available_functional  # noqa: E402
from repro_torch.core.interface import BaseANN  # noqa: E402
from repro_torch.core.registry import available, resolve  # noqa: E402

# The reference's algorithms that the port does not have yet (ROADMAP §1):
# the sharded specs.
NOT_PORTED = {"ShardedBruteForce", "ShardedIVF"}


def test_port_listings_agree():
    """Every registered BaseANN has a functional spec and vice versa."""
    assert set(available()) == set(available_functional())


@pytest.mark.parametrize("listing", ["classes", "functional"])
def test_listings_are_the_references_minus_the_unported(listing):
    port, ref = {"classes": (available, jx_available),
                 "functional": (available_functional,
                                jx_available_functional)}[listing]
    assert NOT_PORTED <= set(ref())
    assert set(port()) == set(ref()) - NOT_PORTED


def test_available_returns_the_resolvable_classes():
    listed = available()
    for name, cls in listed.items():
        assert issubclass(cls, BaseANN)
        assert resolve(name) is cls
    listed.clear()                       # a copy: the registry keeps its own
    assert available()
