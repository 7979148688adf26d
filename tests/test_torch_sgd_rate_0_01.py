"""Sync-step SGD at 0.01 on the full MNIST-like set, both packages
(``tests/torch_sgd_rate.py`` says what it shows and why each rate has
a file of its own)."""
import pytest

torch = pytest.importorskip("torch")

from tests.torch_sgd_rate import (check_sgd_rate, full_mnist_like,  # noqa: F401
                                  one_thread)


@pytest.mark.parametrize("lr", [0.01])
def test_sgd_rate_on_the_full_mnist_like_set(lr, full_mnist_like, one_thread):
    check_sgd_rate(lr, full_mnist_like)
