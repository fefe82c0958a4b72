"""One intra-op torch thread for a test module's run: a module imports
the fixture (``from _torch_threads import _one_thread  # noqa: F401``).
Under the suite's parallel workers every extra thread only contends."""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
