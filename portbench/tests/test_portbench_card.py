"""On the card: the controls, the reference put in the program's place in
TF32, fail a limit of their cell at a size a test run holds (at the cells'
own size they are run by `portbench/control.py`)."""
import pytest

pytestmark = pytest.mark.card


@pytest.mark.parametrize("name", ["imitate.attlwb_spade_512", "subjects.attlwb_spade_512",
                                  "imitate_sharded.attlwb_spade_512.x4",
                                  "personalize.attlwb_spade_512"])
def test_the_tf32_control_fails_a_limit(card, tiny, name):
    from portbench.lib import manifest

    cell = tiny(name)
    cell.config["image_size"] = 128
    numbers = manifest.load_driver(cell.traffic).control(cell, 2 ** 31 + 3, card, 2)
    limits = cell.config["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
