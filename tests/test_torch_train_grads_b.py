"""The second half of ``test_torch_train_grads.py``'s architectures (the
checks and their bounds are defined there)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import ARCHS  # noqa: E402
from test_torch_train_grads import (check_against_reference,  # noqa: E402
                                    check_remat_bitwise)

NAMES = ARCHS[5:]


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_the_reference(name):
    check_against_reference(name)


@pytest.mark.parametrize("name", NAMES)
def test_remat_is_bitwise_equal_to_no_remat(name):
    check_remat_bitwise(name)
