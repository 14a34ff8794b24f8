"""The zoo's ConvTasNet, SuDORMRF, TDANet, AFRCNN and MossFormer: the convolutional classes and MossFormer v1 (its FlashBlocks through the FFConvM and gated FLASH wrappers' plain versions on the CPU), against the JAX package on one parameter tree.

Per class (cases in `torch_zoo_cases.py`): the float32 forward without and
with `lengths` within 1e-4 of the output's peak; the bf16 mode within 1.5
times the JAX bf16 mode's own departure from its float32 run (the margin is
half that departure); a checkpoint the JAX package wrote, loaded with
strict=True; and the inverse converter's names, shapes and values.
"""

import pytest
import torch

from torch_zoo_cases import check_bf16, check_checkpoint, check_forward, check_inverse

NAMES = ["AFRCNN", "ConvTasNet", "MossFormer", "SuDORMRF", "TDANet"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs under pytest-xdist with several
    workers a machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_float32_forward_matches_jax(name, with_lengths):
    check_forward(name, with_lengths)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_mode_matches_jax_bf16_mode(name):
    check_bf16(name)


@pytest.mark.parametrize("name", NAMES)
def test_loads_jax_checkpoint_strict(name, tmp_path):
    check_checkpoint(name, tmp_path)


@pytest.mark.parametrize("name", NAMES)
def test_inverse_converter_gives_jax_names(name):
    check_inverse(name)
