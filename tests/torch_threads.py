"""A fixture for the port's CPU test modules whose work is thousands of
tiny torch operators: ``from torch_threads import one_intra_op_thread``
makes every test of the importing module run on one intra-op thread, and
restores the thread count after the module.

One thread runs such work in a fraction of the CPU time that torch's
intra-op pool burns spinning between operators (the bilevel trainer's
modules alone: 22 against 221 CPU seconds; ``tests/test_torch_bilevel_*``:
107 against 253), which the suite's other workers feel most. Reductions may
sum in another order than on many threads, so results move within the
tests' stated tolerances; a module's bit-for-bit comparisons run both sides
on the same thread count."""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
