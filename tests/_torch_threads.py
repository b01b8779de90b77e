"""One torch thread for the tests of a port module:
``from _torch_threads import one_thread  # noqa: F401`` in a test module
pins torch's intra-op threads to one while its tests run (restored
after). The suite runs several modules at once (``pytest -n``), each of
whose processes would otherwise start a thread a core, and the smoke
sizes' many small ops run 10-70x slower so oversubscribed; a child
process a test starts pins its own (``torch.set_num_threads(1)``), so
ranks compared bitwise with this process sum alike."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
