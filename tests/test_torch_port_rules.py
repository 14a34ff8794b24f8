"""Reference checkpoints into the port: `runtime/port_rules.py` for
MossFormer2, Apollo and the convolutional zoo classes (ConvTasNet,
SuDORMRF, AFRCNN, TDANet), against the JAX package's rules on one seeded
reference-layout state dict (`tools/reference_layout.py`).

Per architecture, at tests/test_convert.py's tiny geometry (cases in
`torch_port_rules_cases.py`): the dict passes the JAX rules and their tree
is the JAX `init` tree; the port's state dict is `CONVERTERS[name]` of that
tree to the bit and loads strictly; the port's forward is within 1e-4 of
the JAX forward's peak; an extra reference key raises KeyError in both.
"""

import pytest
import torch

from torch_port_rules_cases import check_forward, check_state_dict, check_strict, check_tree

torch.set_num_threads(2)  # beside the other test workers' threads

CASES = ["MossFormer2", "Apollo", "ConvTasNet", "SuDORMRF", "AFRCNN", "TDANet"]


@pytest.mark.parametrize("case", CASES)
def test_reference_dict_gives_the_jax_init_tree(case):
    check_tree(case)


@pytest.mark.parametrize("case", CASES)
def test_state_dict_is_the_converted_jax_tree(case):
    check_state_dict(case)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    check_forward(case)


@pytest.mark.parametrize("case", CASES)
def test_unhandled_reference_key_raises(case):
    check_strict(case)
