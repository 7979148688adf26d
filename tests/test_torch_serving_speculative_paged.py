"""The port's paged ``DecodeEngine`` with a draft against the JAX
package's.

As ``test_torch_serving_speculative.py`` does for the contiguous
engines: identical weights through the bridge, the same numpy-seeded
requests, the JAX engines run once per module in a fixture; paged
engines with a draft, adaptive gamma off and on, 6 requests through 2
slots: every output equals solo ``generate``, and the engine's
accepted/proposed counts, slot-rounds, per-request counts and the gamma
after every step equal the JAX engine's.
"""
import pytest

torch = pytest.importorskip("torch")

from tests.torch_speculative_parity import (check_speculative_engine,
                                            jax_engine_runs, models,
                                            one_thread)


@pytest.fixture(scope="module")
def jax_engines(models):
    """The JAX engines' outputs and counters, once per module."""
    return jax_engine_runs(models, "paged")


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["fixed_gamma", "adaptive_gamma"])
@pytest.mark.parametrize("layout", ["paged"])
def test_speculative_engine_matches_jax(models, jax_engines, layout,
                                        adaptive):
    check_speculative_engine(models, jax_engines, layout, adaptive)
