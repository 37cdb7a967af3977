"""On the card, at each cell's own size: the control (the reference with
int4 weights in the program's place) fails one of the cell's compared
numbers on three seeds, while the program passes them.

    python3 -m pytest --noconftest -m cuda benchmark/tests -q

Each cell runs its own traffic for a short window (long enough for its
longest requests), judged as a timed run is."""
import pytest
import torch

CELLS = {"mistral7b.decode": 6.0, "mistral7b.serve": 10.0,
         "mixtral8x7b.decode": 8.0}
SEEDS = [3_000_000_017, 3_000_000_029, 3_000_000_041]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_where_the_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full size")
    from benchmark import calibrate

    for res in calibrate.readings(cell, SEEDS, CELLS[cell], control=True):
        checks = res["checks"]
        assert res["correct"], (res["seed"], checks)
        failed = [n for n in checks if n.startswith("control.")
                  and checks[n]["value"] > checks[n]["limit"]]
        assert failed, (res["seed"], checks)
