"""``one_thread``: an autouse fixture that runs a port test module on one
intra-op thread (``torch.set_num_threads(1)``) and restores the count after
it.  A module opts in by importing it::

    from torch_one_thread import one_thread  # noqa: F401

The suite runs several processes a core (``pytest -n 6`` on a host of
eight, each module's CPU ranks and children beside them), and a torch op's
idle pool threads spin on cores that the other processes wait for.  On one
thread a module's torch work keeps to its own core, and so do the ranks it
spawns (``launch.mesh.spawn`` splits the parent's threads among them); the
smoke shapes gain nothing from more."""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
