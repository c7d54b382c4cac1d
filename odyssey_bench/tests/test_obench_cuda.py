"""On a card: one cell, small, on the port's CUDA path, held to the
reference.  Skips where there is no card."""
import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_small_cell_on_the_card(card):
    from odyssey_bench.harness import run_cell
    from odyssey_bench.tests.small import overrides

    out = run_cell("cdls.queries.closed", 2**31 + 3, 2.0, False, device=card,
                   overrides=overrides("cdls.queries.closed"), log=lambda *a: None)
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
