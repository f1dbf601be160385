"""The committed outputs of the JAX package's tiny encoder and vision
models (``tests/data/tiny_reference.json``, written by
``tests/tiny_reference.py``), and the port held to them on the CPU by
the same check ``chip_smoke.py`` runs on the card.

The file is regenerated here and must equal the committed one: the same
families, entries and shapes, and every value within 2^-20 of its
entry's largest magnitude.  XLA compiles for the host's vector width, so
on another CPU a reduction may sum in another order and move a float32
value by a few of its last bits; a hand-edited or stale file moves
values by far more.  The port's side runs
``chip_smoke.tiny_reference_check`` on the CPU (its limits: 1e-4 of the
largest magnitude for outputs, 1e-3 for gradient leaves), which also
requires the planted faults, ResNet with symmetric padding and BERT with
the mask ignored, to fail that check.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
import tiny_reference


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_file_is_what_the_generator_writes():
    committed = json.loads(tiny_reference.PATH.read_text())
    fresh = json.loads(json.dumps(tiny_reference.outputs()))
    assert committed["seed"] == fresh["seed"] == tiny_reference.SEED
    assert list(committed["families"]) == list(tiny_reference.FAMILIES)
    assert tiny_reference.PATH.stat().st_size < 100_000
    for family, entries in fresh["families"].items():
        assert list(committed["families"][family]) == list(entries)
        for key, e in entries.items():
            c = committed["families"][family][key]
            assert c["shape"] == e["shape"], (family, key)
            got, ref = np.float32(e["values"]), np.float32(c["values"])
            np.testing.assert_allclose(
                got, ref, rtol=0, atol=2 ** -20 * np.abs(ref).max(),
                err_msg=f"{family} {key}")


def test_port_matches_the_reference_file_on_cpu():
    """The card's check, on the CPU: each family within its limits, each
    planted fault beyond them."""
    out = chip_smoke.tiny_reference_check(torch.device("cpu"), "cpu")
    for family in chip_smoke.TINY_FAMILIES:
        assert out[family][0] <= 1.0, (family, out[family])
    for fault in chip_smoke.TINY_FAULTS:
        assert out[fault][0] > 1.0, (fault, out[fault])
